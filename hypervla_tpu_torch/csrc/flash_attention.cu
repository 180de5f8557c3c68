// Forward online-softmax attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hypervla_tpu/ops/flash_attention.py::
// flash_attention (body `_flash_kernel`) and computes what it computes: q, k
// and v are widened to fp32, q is scaled by 1/sqrt(d) in fp32, the scores,
// the probabilities and both products stay in fp32 (P is never rounded to
// the input type), the softmax is the streaming one (running row maximum
// and row sum, the accumulator rescaled as the maximum grows), and the
// output is rounded once to q's type. That is another function than the
// training attention of fused_attention.cu, which rounds scores and P to
// bf16.
//
// What bounds it on this card: at batch 64 (768 heads of 257 x 257 x 64) it
// moves 101 MB against 13 GFLOP of fp32 arithmetic, which on fp32 FMAs fed
// from shared memory ran 8x over the FMA peak's time; on the tensor cores
// the operations (26 GFLOP of bf16 `mma`, below) take less than the bytes,
// and what is left is the fp32 arithmetic around them: per score a scale, a
// maximum, an `expf`, a sum and the three-term split. At the serving shape
// (12 heads) a block's serial walk over the keys is the time.
//
// Design of the bf16 kernel (`flash_tc_kernel`): both products on the bf16
// tensor cores (`mma.sync.m16n8k16`, fp32 accumulators) without changing the
// function, which rests on two facts.
//   Scores. A product of two bf16 values is exact in fp32, so q.k^T on bf16
//   operands with an fp32 sum is the fp32 dot up to the order of the sum,
//   as an FMA chain is. The scale multiplies the fp32 score, not q: for a
//   head dim that is a power of four (64 on every model path, 16) the scale
//   is a power of two and (q * scale).k == (q.k) * scale bit for bit; for
//   other head dims the score moves by one fp32 rounding (2^-24 relative).
//   P.V. V is bf16 and P is fp32 in [0, 1]. P is split in registers into
//   three bf16 terms, hi = bf16(p), mid = bf16(p - hi), lo = bf16(p - hi -
//   mid): hi + mid + lo == p exactly (8 + 8 + 8 significand bits), each
//   term's products with V are exact in fp32, and the three `mma` add into
//   one fp32 accumulator. P is never rounded.
// A warp owns 16 query rows; a block is 2 or 4 warps (the wrapper takes 4
// where that still fills the card). The keys are walked in tiles of 64; K
// and V of a tile are staged as bf16 in shared memory by 16-byte `cp.async`
// along the contiguous head dim through the given strides, the next tile in
// flight while this one is multiplied (two stages); rows are padded by 16
// bytes so that `ldmatrix` (`.trans` for V) reads without bank conflicts.
// The 16 x 64 scores stay in the accumulator registers, and after the
// softmax step the same registers are, term by term, the A operand of P.V:
// P never passes through shared memory. The exponential is `expf`. Keys
// past kv_len are masked with -1e30 as the TPU kernel masks its padding; a
// head dim that is no multiple of 16 is zero-padded in shared memory (DP =
// 16, 32, 64 or 128 columns). Heads are read in place through strides ((B,
// S, heads, d) needs no transpose), and Lq may differ from Lk. Operands
// that are not 16-byte aligned take a scalar load of the same tiles.
//
// The fp32 instantiation (`flash_fwd_kernel<float>`) stays on fp32 FMAs:
// fp32 operands would need three-way splits of both operands, nine products
// a score; it is on no model path at full width. `flash_fwd_kernel<bf16>`
// is kept as the yardstick the tensor-core kernel's error is printed beside.
//
// Plain C interface (loaded with ctypes). The entry point launches on the
// given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ void st(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

constexpr int FA_WARPS = 8;
constexpr int FA_THREADS = FA_WARPS * 32;
constexpr int FA_R = 4;                  // query rows per warp
constexpr int FA_ROWS = FA_WARPS * FA_R; // query rows per block
constexpr int FA_KT = 64;                // keys per tile: two per lane
constexpr int FA_MAXDPL = 4;             // head dims per lane: d <= 128
constexpr float FA_NEG_INF = -1e30f;

// Strides in elements; the head dim has stride 1.
struct FaStrides {
  long long batch, head, row;
};

template <typename T>
__global__ void __launch_bounds__(FA_THREADS) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, FaStrides sq, FaStrides sk, FaStrides sv,
    FaStrides so, int heads, int q_len, int kv_len, int d, float sm_scale) {
  extern __shared__ float smem[];
  const int kpad = d + 1;  // lanes on neighbouring keys hit different banks
  float* Ks = smem;                       // FA_KT x (d + 1)
  float* Vs = Ks + FA_KT * kpad;          // FA_KT x d
  float* Qs = Vs + FA_KT * d;             // FA_ROWS x d, scaled
  float* Ps = Qs + FA_ROWS * d;           // FA_ROWS x FA_KT

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int row0 = blockIdx.x * FA_ROWS;
  const T* qh = q + b * sq.batch + h * sq.head;
  const T* kh = k + b * sk.batch + h * sk.head;
  const T* vh = v + b * sv.batch + h * sv.head;
  T* oh = out + b * so.batch + h * so.head;

  // a warp loads a row at a time, a lane every 32nd column
  for (int r = warp; r < FA_ROWS; r += FA_WARPS)
    for (int c = lane; c < d; c += 32)
      Qs[r * d + c] =
          row0 + r < q_len
              ? ld(qh + (long long)(row0 + r) * sq.row + c) * sm_scale
              : 0.f;

  float row_max[FA_R], row_sum[FA_R], acc[FA_R][FA_MAXDPL];
#pragma unroll
  for (int rr = 0; rr < FA_R; ++rr) {
    row_max[rr] = FA_NEG_INF;
    row_sum[rr] = 0.f;
#pragma unroll
    for (int j = 0; j < FA_MAXDPL; ++j) acc[rr][j] = 0.f;
  }
  const float* qw = Qs + warp * FA_R * d;
  float* pw = Ps + warp * FA_R * FA_KT;

  for (int k0 = 0; k0 < kv_len; k0 += FA_KT) {
    __syncthreads();  // the previous tile has been read (and Qs is written)
    for (int r = warp; r < FA_KT; r += FA_WARPS) {
      const bool live = k0 + r < kv_len;
      for (int c = lane; c < d; c += 32) {
        Ks[r * kpad + c] =
            live ? ld(kh + (long long)(k0 + r) * sk.row + c) : 0.f;
        Vs[r * d + c] =
            live ? ld(vh + (long long)(k0 + r) * sv.row + c) : 0.f;
      }
    }
    __syncthreads();

    // scores of this warp's rows against keys lane and lane + 32
    float s[FA_R][2];
#pragma unroll
    for (int rr = 0; rr < FA_R; ++rr) s[rr][0] = s[rr][1] = 0.f;
    const float* ka = Ks + lane * kpad;
    const float* kb = Ks + (lane + 32) * kpad;
    for (int c = 0; c < d; ++c) {
      const float k_a = ka[c], k_b = kb[c];
#pragma unroll
      for (int rr = 0; rr < FA_R; ++rr) {
        const float qv = qw[rr * d + c];
        s[rr][0] = fmaf(qv, k_a, s[rr][0]);
        s[rr][1] = fmaf(qv, k_b, s[rr][1]);
      }
    }
    const bool live_a = k0 + lane < kv_len, live_b = k0 + lane + 32 < kv_len;
#pragma unroll
    for (int rr = 0; rr < FA_R; ++rr) {
      const float sa = live_a ? s[rr][0] : FA_NEG_INF;
      const float sb = live_b ? s[rr][1] : FA_NEG_INF;
      const float new_max = fmaxf(row_max[rr], warp_max(fmaxf(sa, sb)));
      const float correction = expf(row_max[rr] - new_max);
      const float pa = expf(sa - new_max), pb = expf(sb - new_max);
      row_sum[rr] = row_sum[rr] * correction + warp_sum(pa + pb);
      row_max[rr] = new_max;
#pragma unroll
      for (int j = 0; j < FA_MAXDPL; ++j) acc[rr][j] *= correction;
      pw[rr * FA_KT + lane] = pa;
      pw[rr * FA_KT + lane + 32] = pb;
    }
    __syncwarp();

    // acc += P . V, a lane owning head dims lane, lane + 32, ...
    for (int kk = 0; kk < FA_KT; ++kk) {
      float vv[FA_MAXDPL];
#pragma unroll
      for (int j = 0; j < FA_MAXDPL; ++j) {
        const int c = lane + 32 * j;
        vv[j] = c < d ? Vs[kk * d + c] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < FA_R; ++rr) {
        const float p = pw[rr * FA_KT + kk];
#pragma unroll
        for (int j = 0; j < FA_MAXDPL; ++j)
          acc[rr][j] = fmaf(p, vv[j], acc[rr][j]);
      }
    }
    __syncwarp();  // P has been read before the next tile overwrites it
  }

#pragma unroll
  for (int rr = 0; rr < FA_R; ++rr) {
    const int row = row0 + warp * FA_R + rr;
    if (row >= q_len) continue;
#pragma unroll
    for (int j = 0; j < FA_MAXDPL; ++j) {
      const int c = lane + 32 * j;
      if (c < d) st(oh + (long long)row * so.row + c, acc[rr][j] / row_sum[rr]);
    }
  }
}

// ------------------------- the tensor-core kernel -------------------------

constexpr int TC_KT = 64;  // keys per tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; without `pred` nothing is read and the 16
// bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8. Thread (g = lane / 4, t = lane % 4) receives, of each matrix,
// [row g][cols 2t, 2t+1], or with .trans [rows 2t, 2t+1][col g].
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a . b: a 16x16 (row), b 16x8 (col), c 16x8 fp32. Thread (g, t) holds
// a0 = a[g][2t..], a1 = a[g+8][2t..], a2 = a[g][2t+8..], a3 = a[g+8][2t+8..];
// b0 = b[2t..][g], b1 = b[2t+8..][g]; c0,c1 = c[g][2t, 2t+1], c2,c3 =
// c[g+8][2t, 2t+1].
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// p0, p1 as three bf16 pairs whose sum is p exactly: the residual of a
// round-to-nearest bf16 has at most 16 significant bits, the next at most 8.
// Each pair is one packed conversion (p0 in the low half).
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ void split3(float p0, float p1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = p0 - hf.x, r1 = p1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
}

// Starts the copy of keys [k0, k0 + TC_KT) x DP columns of one head into a
// (TC_KT, DP + 8) tile; keys at or past kv_len and columns at or past d are
// zero. `vec`: 16-byte cp.async chunks; else scalar loads (done on return).
template <int DP>
__device__ __forceinline__ void load_kv_tile(bf16* dst, const bf16* src,
                                             long long row_stride, int k0,
                                             int kv_len, int d, bool vec) {
  constexpr int LDS = DP + 8;
  if (vec) {
    for (int i = threadIdx.x; i < TC_KT * (DP / 8); i += blockDim.x) {
      const int r = i / (DP / 8), c = (i % (DP / 8)) * 8;
      const bool in = k0 + r < kv_len && c < d;
      cp_async16(dst + r * LDS + c,
                 in ? src + (long long)(k0 + r) * row_stride + c : src, in);
    }
  } else {
    for (int i = threadIdx.x; i < TC_KT * DP; i += blockDim.x) {
      const int r = i / DP, c = i % DP;
      dst[r * LDS + c] = k0 + r < kv_len && c < d
                             ? src[(long long)(k0 + r) * row_stride + c]
                             : __float2bfloat16_rn(0.f);
    }
  }
}

// grid (ceil(q_len / (16 warps)), batch * heads); 32 * warps threads, warps
// 2 or 4. DP: the head dim rounded up to 16, 32, 64 or 128.
template <int DP>
__global__ void __launch_bounds__(128) flash_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out, FaStrides sq,
    FaStrides sk, FaStrides sv, FaStrides so, int heads, int q_len,
    int kv_len, int d, float sm_scale, int vec) {
  constexpr int LDS = DP + 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* tiles = reinterpret_cast<bf16*>(tc_smem);  // [stage][K, V][TC_KT][LDS]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const bf16* qh = q + b * sq.batch + h * sq.head;
  const bf16* kh = k + b * sk.batch + h * sk.head;
  const bf16* vh = v + b * sv.batch + h * sv.head;
  bf16* oh = out + b * so.batch + h * so.head;
  const int m0 = (blockIdx.x * (blockDim.x >> 5) + warp) * 16;
  const bool live = m0 < q_len;  // a dead warp still loads and synchronises

  auto load_stage = [&](int stage, int k0) {
    bf16* ks = tiles + (size_t)stage * 2 * TC_KT * LDS;
    load_kv_tile<DP>(ks, kh, sk.row, k0, kv_len, d, vec);
    load_kv_tile<DP>(ks + TC_KT * LDS, vh, sv.row, k0, kv_len, d, vec);
  };
  load_stage(0, 0);
  cp_async_commit();

  // q's 16 rows as A operands; rows past q_len and columns past d are zero
  uint32_t qa[DP / 16][4];
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + g + (i & 1) * 8;
      const int col = 16 * ks + 2 * t + (i >> 1) * 8;
      const bf16* src = qh + (long long)row * sq.row + col;
      const bf16 zero = __float2bfloat16_rn(0.f);
      qa[ks][i] = pack2(row < q_len && col < d ? src[0] : zero,
                        row < q_len && col + 1 < d ? src[1] : zero);
    }

  float row_max[2] = {FA_NEG_INF, FA_NEG_INF}, row_sum[2] = {0.f, 0.f};
  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  const int tiles_n = (kv_len + TC_KT - 1) / TC_KT;
  for (int it = 0; it < tiles_n; ++it) {
    if (it + 1 < tiles_n) load_stage((it + 1) & 1, (it + 1) * TC_KT);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (live) {
      const bf16* Ks = tiles + (size_t)(it & 1) * 2 * TC_KT * LDS;
      const bf16* Vs = Ks + TC_KT * LDS;
      const int k0 = it * TC_KT;

      // scores of 16 rows x 64 keys; matrix l/8 of an x4 load: keys +8 for
      // matrices 2, 3; columns +8 for 1, 3
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
      const bf16* kbase = Ks + ((lane & 7) + ((lane >> 4) << 3)) * LDS +
                          ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int jp = 0; jp < 4; ++jp)
#pragma unroll
        for (int ks = 0; ks < DP / 16; ++ks) {
          uint32_t kb[4];
          ldsm_x4(kb, kbase + 16 * jp * LDS + 16 * ks);
          mma_bf16(s[2 * jp], qa[ks], kb[0], kb[1]);
          mma_bf16(s[2 * jp + 1], qa[ks], kb[2], kb[3]);
        }

      // the streaming softmax step; row r of the pair is g + 8r
      float tile_max[2] = {FA_NEG_INF, FA_NEG_INF};
      const bool ragged = k0 + TC_KT > kv_len;  // only the last tile masks
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[j][i] *= sm_scale;
          if (ragged && k0 + 8 * j + 2 * t + (i & 1) >= kv_len)
            s[j][i] = FA_NEG_INF;
          tile_max[i >> 1] = fmaxf(tile_max[i >> 1], s[j][i]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float new_max = fmaxf(row_max[r], quad_max(tile_max[r]));
        const float correction = expf(row_max[r] - new_max);
        row_max[r] = new_max;
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[j][2 * r] = expf(s[j][2 * r] - new_max);
          s[j][2 * r + 1] = expf(s[j][2 * r + 1] - new_max);
          part += s[j][2 * r] + s[j][2 * r + 1];
        }
        // the quad's four partial sums are added after the last tile
        row_sum[r] = row_sum[r] * correction + part;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          acc[j][2 * r] *= correction;
          acc[j][2 * r + 1] *= correction;
        }
      }

      // acc += P . V, one mma per bf16 term of P; V read transposed: matrix
      // l/8 of an x4 load: keys +8 for matrices 1, 3; columns +8 for 2, 3
      const bf16* vbase = Vs + ((lane & 7) + (((lane >> 3) & 1) << 3)) * LDS +
                          (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t hi[4], mid[4], lo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          // a0, a1: rows g, g + 8 of keys 16kk + 2t..; a2, a3: keys + 8
          split3(s[2 * kk + (i >> 1)][2 * (i & 1)],
                 s[2 * kk + (i >> 1)][2 * (i & 1) + 1], hi[i], mid[i], lo[i]);
#pragma unroll
        for (int dp = 0; dp < DP / 16; ++dp) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, vbase + 16 * kk * LDS + 16 * dp);
          mma_bf16(acc[2 * dp], hi, vb[0], vb[1]);
          mma_bf16(acc[2 * dp + 1], hi, vb[2], vb[3]);
          mma_bf16(acc[2 * dp], mid, vb[0], vb[1]);
          mma_bf16(acc[2 * dp + 1], mid, vb[2], vb[3]);
          mma_bf16(acc[2 * dp], lo, vb[0], vb[1]);
          mma_bf16(acc[2 * dp + 1], lo, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // the tile has been read before its stage is refilled
  }
  if (!live) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + g + 8 * r;
    if (row >= q_len) continue;
    const float sum = quad_sum(row_sum[r]);
    bf16* orow = oh + (long long)row * so.row;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * t;
      const bf16 o0 = __float2bfloat16_rn(acc[j][2 * r] / sum);
      const bf16 o1 = __float2bfloat16_rn(acc[j][2 * r + 1] / sum);
      if (vec && col < d) {
        *reinterpret_cast<uint32_t*>(orow + col) = pack2(o0, o1);
      } else {
        if (col < d) orow[col] = o0;
        if (col + 1 < d) orow[col + 1] = o1;
      }
    }
  }
}

template <int DP>
static cudaError_t launch_flash_tc(dim3 grid, int warps, cudaStream_t stream,
                                   const bf16* q, const bf16* k,
                                   const bf16* v, bf16* out, FaStrides sq,
                                   FaStrides sk, FaStrides sv, FaStrides so,
                                   int heads, int q_len, int kv_len, int d,
                                   float sm_scale, int vec) {
  const size_t smem = (size_t)2 * 2 * TC_KT * (DP + 8) * sizeof(bf16);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  flash_tc_kernel<DP><<<grid, 32 * warps, smem, stream>>>(
      q, k, v, out, sq, sk, sv, so, heads, q_len, kv_len, d, sm_scale, vec);
  return cudaGetLastError();
}

extern "C" {

// The widest head the kernel takes.
int flash_attention_max_head_dim() { return 32 * FA_MAXDPL; }

// q, out: (batch, q_len, heads, d); k, v: (batch, kv_len, heads, d), each
// read through its (batch, head, row) strides in elements, the head dim
// contiguous. is_f32: all four fp32, else bf16. sm_scale multiplies q (the
// fp32 kernel) or the scores (the tensor-core kernel). bf16 takes the
// tensor-core kernel with `warps` (2 or 4) warps a block, 16-byte loads
// with `vec` (every operand 16-byte aligned with strides and d multiples of
// 8); `fma` forces the fp32-FMA kernel on bf16 (the error yardstick).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, long long q_sb, long long q_sh,
                        long long q_sr, long long k_sb, long long k_sh,
                        long long k_sr, long long v_sb, long long v_sh,
                        long long v_sr, long long o_sb, long long o_sh,
                        long long o_sr, int batch, int heads, int q_len,
                        int kv_len, int d, float sm_scale, int is_f32,
                        int warps, int vec, int fma, void* stream) {
  const FaStrides sq{q_sb, q_sh, q_sr}, sk{k_sb, k_sh, k_sr},
      sv{v_sb, v_sh, v_sr}, so{o_sb, o_sh, o_sr};
  cudaStream_t s = (cudaStream_t)stream;
  if (!is_f32 && !fma) {
    const dim3 grid((q_len + 16 * warps - 1) / (16 * warps), batch * heads);
#define LAUNCH_TC(DP)                                                      \
  return (int)launch_flash_tc<DP>(grid, warps, s, (const bf16*)q,          \
                                  (const bf16*)k, (const bf16*)v,          \
                                  (bf16*)out, sq, sk, sv, so, heads, q_len, \
                                  kv_len, d, sm_scale, vec)
    if (d <= 16) LAUNCH_TC(16);
    if (d <= 32) LAUNCH_TC(32);
    if (d <= 64) LAUNCH_TC(64);
    LAUNCH_TC(128);
#undef LAUNCH_TC
  }
  const dim3 grid((q_len + FA_ROWS - 1) / FA_ROWS, batch * heads);
  const size_t smem =
      sizeof(float) * (FA_KT * (2 * d + 1) + FA_ROWS * (d + FA_KT));
  cudaError_t err;
  if (is_f32) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_kernel<float><<<grid, FA_THREADS, smem, s>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out, sq,
        sk, sv, so, heads, q_len, kv_len, d, sm_scale);
  } else {
    err = cudaFuncSetAttribute(flash_fwd_kernel<bf16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_kernel<bf16><<<grid, FA_THREADS, smem, s>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, sq, sk,
        sv, so, heads, q_len, kv_len, d, sm_scale);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
