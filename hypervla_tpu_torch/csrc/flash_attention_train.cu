// Differentiable attention for Hopper (sm_90a): a forward and a backward
// that never write the probabilities P to global memory.
//
// Replaces no Pallas kernel of this repository: it is the counterpart of
// hypervla_tpu/ops/flash_attention.py::mha_flash_trainable, which on a TPU
// calls jax's library flash attention (whose VJP recomputes P) and
// elsewhere runs an einsum attention. What it computes is that einsum
// function and its VJP, with their rounding points, for T = bf16 or fp32
// inputs over (batch, seq, heads, head_dim):
//   forward   qs = fp32(q) * scale (scale = fp32(1 / sqrt(d)));
//             s = qs . fp32(k)^T in fp32; m = max s; e = exp(s - m);
//             n = sum e; p = e / n; o = T(T(p) . v) with an fp32 sum;
//   backward  dv = T(T(p)^T . g); dp = fp32(T(g . v^T));
//             r = sum_k (dp * (1 / (n * n))) * e;
//             ds = (dp / n - r) * e in fp32;
//             dq = T(fp32(ds . k) * scale); dk = T(ds^T . qs).
// For fp32 inputs every T is the identity.
//
// The forward saves only the row max m and the row sum n (fp32, B x H x S)
// beside q, k, v. Because p is rounded after the division by n, the
// forward takes two sweeps over the keys: the first finds m and n (the
// streaming maximum and rescaled sum), the second recomputes s and p and
// multiplies T(p) by v. The backward is two kernels, each recomputing s
// and p from m and n with the forward's own code, so the recomputed p is
// the forward's bit for bit:
//   * the dq kernel, one block per 64 query rows, sweeps the keys twice:
//     first for the row term r (which cannot come from rowsum(g * o), as
//     o was built from the rounded p and rounded again), written to a
//     B x H x S fp32 scratch, then for dq;
//   * the dk/dv kernel, one block per 64 keys, loops over the query tiles
//     and reads r from that scratch.
// Every sum runs in a fixed order: no atomics, and two runs repeat bit for
// bit.
//
// bf16 inputs run on the bf16 tensor cores (`mma.sync.m16n8k16`, fp32
// sums, csrc/mma_sync.cuh) without changing the function, because a
// product of two bf16 values is exact in fp32. An fp32 operand is split
// into three bf16 terms, hi = bf16(x), mid = bf16(x - hi), lo = bf16(x -
// hi - mid), whose sum is x exactly (8 + 8 + 8 significand bits), and each
// term is one more product into the same fp32 sum: qs in the scores and in
// dk (one term where the scale is a power of two, as at head dim 16 and
// 64: then fp32(q) * scale is a bf16 value), ds in dq and dk (always three
// terms: ds is fp32 in the function). A warp owns 16 query rows of a
// 64-row block; K, V (or, in the dk/dv kernel, Q's terms and g) are
// staged in shared memory as bf16 rows padded by 16 bytes, read by
// `ldmatrix` (`.trans` where the product's inner dimension runs down the
// rows). The score and dp accumulators stay in registers; in the forward
// and the dq kernel they become, pair by pair, the A operand of the next
// product. In the dk/dv kernel P and ds's terms pass through shared
// memory, transposed by `ldmatrix.trans` there. The head dim is zero-padded
// to DP = 32, 64 or 128 columns; a head dim that is no multiple of 8 takes
// plain loads instead of 16-byte `cp.async`.
//
// fp32 inputs run on fp32 FMAs (no TF32): the same three kernels with a
// warp owning 4 rows (forward, dq) or 4 keys (dk/dv) and a lane two keys
// or two queries of a 64-wide tile, every dot an FMA chain over the head
// dim in one order, so the recomputed scores are the forward's bit for
// bit there too.
//
// What bounds it on this card: at the flagship's shape (64 x 257 tokens,
// 12 heads of 64, bf16) the forward moves 3 x 25.3 MB in and 25.3 MB out,
// ~0.03 ms at 3.35 TB/s, and does 2 x 2 x 257^2 x 64 x 768 = 13 GFLOP of
// scores and 6.5 of P.V on the tensor cores; the exponentials and the
// divisions around them (two sweeps, ~101 M each) are what a first
// version pays for. This first version is right and simple first: one
// stage of loads, a block at a time on each tile.
//
// Plain C interface (loaded with ctypes). Each entry point launches on the
// given stream and returns cudaGetLastError().

#include "mma_sync.cuh"  // bf16, ldsm_x4(_trans), mma_bf16, quad_*, cp_async

constexpr int TQ = 64;        // query rows of a block (4 warps x 16)
constexpr int TK = 64;        // keys of a tile
constexpr int PLDS = TK + 8;  // row stride of a (queries x keys) bf16 tile
constexpr int TC_THREADS = 128;
constexpr float NEG = -1e30f;  // a masked key's score

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// p0, p1 as three packed bf16 pairs whose sum is (p0, p1) exactly.
__device__ __forceinline__ void split3(float p0, float p1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = __fsub_rn(p0, hf.x), r1 = __fsub_rn(p1, hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(__fsub_rn(r0, mf.x), __fsub_rn(r1, mf.y));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// ------------------------------ bf16 tiles ------------------------------

// Rows [r0, r0 + rows) x DP columns of one head (row stride ld) into a
// (rows, DP + 8) shared tile; rows at or past S and columns at or past d
// are zero. `vec`: 16-byte cp.async (done at the next wait), else plain
// loads.
template <int DP>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long ld, int r0, int rows,
                                          int S, int d, bool vec) {
  constexpr int LDS = DP + 8;
  if (vec) {
    for (int i = threadIdx.x; i < rows * (DP / 8); i += blockDim.x) {
      const int r = i / (DP / 8), c = (i % (DP / 8)) * 8;
      const bool in = r0 + r < S && c < d;
      cp_async16(smem_u32(dst + r * LDS + c),
                 in ? src + (long long)(r0 + r) * ld + c : src, in);
    }
  } else {
    for (int i = threadIdx.x; i < rows * DP; i += blockDim.x) {
      const int r = i / DP, c = i % DP;
      dst[r * LDS + c] = r0 + r < S && c < d
                             ? src[(long long)(r0 + r) * ld + c]
                             : __float2bfloat16_rn(0.f);
    }
  }
}

// The nt bf16 terms of qs = fp32(q) * scale for rows [r0, r0 + TQ), each
// a (TQ, DP + 8) tile, TQ * (DP + 8) values apart.
template <int DP>
__device__ __forceinline__ void load_q_terms(bf16* dst, const bf16* src,
                                             long long ld, int r0, int S,
                                             int d, float scale, int nt) {
  constexpr int LDS = DP + 8;
  for (int i = threadIdx.x; i < TQ * DP; i += blockDim.x) {
    const int r = i / DP, c = i % DP;
    const float x =
        r0 + r < S && c < d
            ? __fmul_rn(__bfloat162float(src[(long long)(r0 + r) * ld + c]),
                        scale)
            : 0.f;
    const bf16 hi = __float2bfloat16_rn(x);
    dst[r * LDS + c] = hi;
    if (nt > 1) {
      const float r1 = __fsub_rn(x, __bfloat162float(hi));
      const bf16 mid = __float2bfloat16_rn(r1);
      dst[TQ * LDS + r * LDS + c] = mid;
      dst[2 * TQ * LDS + r * LDS + c] =
          __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(mid)));
    }
  }
}

// s = A . B^T for a warp's 16 rows of A (nt terms, tstride values apart)
// against the 64 rows of B, both (rows, DP + 8) bf16 tiles: the scores
// (A = qs's terms, B = K) or dp (A = g, B = V). Every kernel computes its
// scores here, in this order, so that they agree bit for bit.
template <int DP>
__device__ __forceinline__ void dot_tile(float (&s)[8][4], const bf16* A,
                                         int tstride, int nt, const bf16* B) {
  constexpr int LDS = DP + 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
  const bf16* abase = A + (lane & 15) * LDS + (lane >> 4) * 8;
  // matrix l/8 of an x4 load: rows +8 for matrices 2, 3; columns +8 for 1, 3
  const bf16* bbase =
      B + ((lane & 7) + ((lane >> 4) << 3)) * LDS + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks)
    for (int term = 0; term < nt; ++term) {
      uint32_t a[4];
      ldsm_x4(a, abase + term * tstride + 16 * ks);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b[4];
        ldsm_x4(b, bbase + 16 * jp * LDS + 16 * ks);
        mma_bf16(s[2 * jp], a, b[0], b[1]);
        mma_bf16(s[2 * jp + 1], a, b[2], b[3]);
      }
    }
}

// acc += a . B[k0 .. k0 + 16): a holds 16 rows x 16 of B's rows as an A
// operand, B a (rows, DP + 8) tile read transposed.
template <int DP>
__device__ __forceinline__ void dot_rows(float (&acc)[DP / 8][4],
                                         const uint32_t (&a)[4],
                                         const bf16* B, int k0) {
  constexpr int LDS = DP + 8;
  const int lane = threadIdx.x & 31;
  // matrix l/8 of an x4 load: rows +8 for matrices 1, 3; columns +8 for 2, 3
  const bf16* base =
      B + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * LDS + (lane >> 4) * 8;
#pragma unroll
  for (int dp = 0; dp < DP / 16; ++dp) {
    uint32_t b[4];
    ldsm_x4_trans(b, base + 16 * dp);
    mma_bf16(acc[2 * dp], a, b[0], b[1]);
    mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
  }
}

// The A operand of keys [16 kk, 16 kk + 16) of a 16 x 64 accumulator:
// a0, a1 rows g, g + 8 of keys 16kk + 2t..; a2, a3 the same 8 keys on.
__device__ __forceinline__ float acc_at(const float (&s)[8][4], int kk, int i,
                                        int half) {
  return s[2 * kk + (i >> 1)][2 * (i & 1) + half];
}

template <int DP>
__device__ __forceinline__ void store_rows(bf16* dst, long long ld, int row0,
                                           int S, int d,
                                           const float (&acc)[DP / 8][4],
                                           float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = 8 * j + 2 * t + h;
        if (col < d)
          dst[(long long)row * ld + col] =
              __float2bfloat16_rn(__fmul_rn(acc[j][2 * r + h], mul));
      }
  }
}

// ---------------------------- bf16 forward ------------------------------

// grid (ceil(S / 64), batch * heads), 128 threads.
template <int DP>
__global__ void __launch_bounds__(TC_THREADS) fwd_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ mo,
    float* __restrict__ no, int heads, int S, int d, float scale, int nt,
    int vec) {
  constexpr int LDS = DP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qt = reinterpret_cast<bf16*>(smem_raw);  // [3][TQ][LDS]
  bf16* Ks = Qt + 3 * TQ * LDS;                   // [TK][LDS]
  bf16* Vs = Ks + TK * LDS;                       // [TK][LDS]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const long long ld = (long long)heads * d;
  const long long base = (long long)b * S * ld + (long long)h * d;
  const int q0 = blockIdx.x * TQ, w0 = q0 + 16 * warp;
  const bf16* Aw = Qt + 16 * warp * LDS;
  load_q_terms<DP>(Qt, q + base, ld, q0, S, d, scale, nt);

  // sweep 1: the row max and the row sum (rescaled as the max grows)
  float m[2] = {NEG, NEG}, n[2] = {0.f, 0.f};
  const int tiles = (S + TK - 1) / TK;
  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * TK;
    __syncthreads();
    load_rows<DP>(Ks, k + base, ld, k0, TK, S, d, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float s[8][4];
    dot_tile<DP>(s, Aw, TQ * LDS, nt, Ks);
    float tmax[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (k0 + 8 * j + 2 * t + (i & 1) >= S) s[j][i] = NEG;
        tmax[i >> 1] = fmaxf(tmax[i >> 1], s[j][i]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mx = fmaxf(m[r], quad_max(tmax[r]));
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        part = __fadd_rn(
            part, __fadd_rn(expf(__fsub_rn(s[j][2 * r], mx)),
                            expf(__fsub_rn(s[j][2 * r + 1], mx))));
      n[r] = __fadd_rn(__fmul_rn(n[r], expf(__fsub_rn(m[r], mx))), part);
      m[r] = mx;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) n[r] = quad_sum(n[r]);

  // sweep 2: p = e / n rounded to bf16, o = p . v
  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * TK;
    __syncthreads();
    load_rows<DP>(Ks, k + base, ld, k0, TK, S, d, vec);
    load_rows<DP>(Vs, v + base, ld, k0, TK, S, d, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float s[8][4];
    dot_tile<DP>(s, Aw, TQ * LDS, nt, Ks);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        s[j][i] = k0 + 8 * j + 2 * t + (i & 1) < S
                      ? __fdiv_rn(expf(__fsub_rn(s[j][i], m[r])), n[r])
                      : 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = pack2(acc_at(s, kk, i, 0), acc_at(s, kk, i, 1));
      dot_rows<DP>(acc, a, Vs, 16 * kk);
    }
  }
  store_rows<DP>(o + base, ld, w0, S, d, acc, 1.f);
  if (t == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = w0 + g + 8 * r;
      if (row < S) {
        mo[(long long)bh * S + row] = m[r];
        no[(long long)bh * S + row] = n[r];
      }
    }
}

// ---------------------------- bf16 backward -----------------------------

// Per element of a warp's 16 x 64 tile: e, and dp rounded to bf16.
struct RowStats {
  float m[2], n[2], nis[2], r[2];
};

__device__ __forceinline__ RowStats load_stats(const float* mo,
                                               const float* no, int row0,
                                               int S) {
  const int g = (threadIdx.x & 31) >> 2;
  RowStats st;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    st.m[r] = row < S ? mo[row] : 0.f;
    st.n[r] = row < S ? no[row] : 1.f;
    st.nis[r] = __fdiv_rn(1.f, __fmul_rn(st.n[r], st.n[r]));
    st.r[r] = 0.f;
  }
  return st;
}

// grid (ceil(S / 64), batch * heads), 128 threads: dq, and the row term r
// for the dk/dv kernel.
template <int DP>
__global__ void __launch_bounds__(TC_THREADS) bwd_dq_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ gr,
    const float* __restrict__ mo, const float* __restrict__ no,
    float* __restrict__ ro, bf16* __restrict__ dq, int heads, int S, int d,
    float scale, int nt, int vec) {
  constexpr int LDS = DP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qt = reinterpret_cast<bf16*>(smem_raw);  // [3][TQ][LDS]
  bf16* Gs = Qt + 3 * TQ * LDS;                   // [TQ][LDS]
  bf16* Ks = Gs + TQ * LDS;                       // [TK][LDS]
  bf16* Vs = Ks + TK * LDS;                       // [TK][LDS]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const long long ld = (long long)heads * d;
  const long long base = (long long)b * S * ld + (long long)h * d;
  const int q0 = blockIdx.x * TQ, w0 = q0 + 16 * warp;
  load_q_terms<DP>(Qt, q + base, ld, q0, S, d, scale, nt);
  load_rows<DP>(Gs, gr + base, ld, q0, TQ, S, d, vec);
  RowStats st = load_stats(mo + (long long)bh * S, no + (long long)bh * S,
                           w0, S);
  const int tiles = (S + TK - 1) / TK;
  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  // sweep 0 sums r = sum (dp * nis) * e; sweep 1 forms ds and dq
#pragma unroll 1
  for (int sweep = 0; sweep < 2; ++sweep) {
    for (int it = 0; it < tiles; ++it) {
      const int k0 = it * TK;
      __syncthreads();
      load_rows<DP>(Ks, k + base, ld, k0, TK, S, d, vec);
      load_rows<DP>(Vs, v + base, ld, k0, TK, S, d, vec);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      float s[8][4], dpt[8][4];
      dot_tile<DP>(s, Qt + 16 * warp * LDS, TQ * LDS, nt, Ks);
      dot_tile<DP>(dpt, Gs + 16 * warp * LDS, 0, 1, Vs);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          const bool live = k0 + 8 * j + 2 * t + (i & 1) < S;
          const float e = live ? expf(__fsub_rn(s[j][i], st.m[r])) : 0.f;
          const float dp = bf16_round(dpt[j][i]);
          if (sweep == 0) {
            st.r[r] = __fadd_rn(
                st.r[r], __fmul_rn(__fmul_rn(dp, st.nis[r]), e));
          } else {
            s[j][i] = __fmul_rn(
                __fsub_rn(__fdiv_rn(dp, st.n[r]), st.r[r]), e);
          }
        }
      if (sweep == 1) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t hi[4], mid[4], lo[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            split3(acc_at(s, kk, i, 0), acc_at(s, kk, i, 1), hi[i], mid[i],
                   lo[i]);
          dot_rows<DP>(acc, hi, Ks, 16 * kk);
          dot_rows<DP>(acc, mid, Ks, 16 * kk);
          dot_rows<DP>(acc, lo, Ks, 16 * kk);
        }
      }
    }
    if (sweep == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        st.r[r] = quad_sum(st.r[r]);
        const int row = w0 + g + 8 * r;
        if (t == 0 && row < S) ro[(long long)bh * S + row] = st.r[r];
      }
    }
  }
  store_rows<DP>(dq + base, ld, w0, S, d, acc, scale);
}

// grid (ceil(S / 64), batch * heads), 128 threads: a block owns 64 keys,
// a warp 16 of them in the products dv = P^T . g and dk = ds^T . qs.
template <int DP>
__global__ void __launch_bounds__(TC_THREADS) bwd_dkdv_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ gr,
    const float* __restrict__ mo, const float* __restrict__ no,
    const float* __restrict__ ro, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int heads, int S, int d, float scale, int nt,
    int vec) {
  constexpr int LDS = DP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Kb = reinterpret_cast<bf16*>(smem_raw);  // [TK][LDS], the block's
  bf16* Vb = Kb + TK * LDS;                       // [TK][LDS]
  bf16* Qt = Vb + TK * LDS;                       // [3][TQ][LDS]
  bf16* Gs = Qt + 3 * TQ * LDS;                   // [TQ][LDS]
  bf16* Ps = Gs + TQ * LDS;                       // [TQ][PLDS]
  bf16* Dt = Ps + TQ * PLDS;                      // [3][TQ][PLDS]
  float* Ms = reinterpret_cast<float*>(Dt + 3 * TQ * PLDS);  // [3][TQ]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const long long ld = (long long)heads * d;
  const long long base = (long long)b * S * ld + (long long)h * d;
  const int k0 = blockIdx.x * TK;
  load_rows<DP>(Kb, k + base, ld, k0, TK, S, d, vec);
  load_rows<DP>(Vb, v + base, ld, k0, TK, S, d, vec);
  float dva[DP / 8][4], dka[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dva[j][i] = dka[j][i] = 0.f;
  const float* mh = mo + (long long)bh * S;
  const float* nh = no + (long long)bh * S;
  const float* rh = ro + (long long)bh * S;

  for (int q0 = 0; q0 < S; q0 += TQ) {
    __syncthreads();  // the previous tile's products have read smem
    load_q_terms<DP>(Qt, q + base, ld, q0, S, d, scale, nt);
    load_rows<DP>(Gs, gr + base, ld, q0, TQ, S, d, vec);
    for (int i = threadIdx.x; i < TQ; i += blockDim.x) {
      const bool in = q0 + i < S;
      Ms[i] = in ? mh[q0 + i] : 0.f;
      Ms[TQ + i] = in ? nh[q0 + i] : 1.f;
      Ms[2 * TQ + i] = in ? rh[q0 + i] : 0.f;
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // this warp's 16 queries against the block's 64 keys: P and ds
    float s[8][4], dpt[8][4];
    dot_tile<DP>(s, Qt + 16 * warp * LDS, TQ * LDS, nt, Kb);
    dot_tile<DP>(dpt, Gs + 16 * warp * LDS, 0, 1, Vb);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qr = 16 * warp + g + 8 * r;  // row in the tile
      const float m = Ms[qr], n = Ms[TQ + qr], rr = Ms[2 * TQ + qr];
      const bool qlive = q0 + qr < S;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p[2], ds[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 2 * r + hh;
          const bool live = qlive && k0 + 8 * j + 2 * t + hh < S;
          const float e = expf(__fsub_rn(s[j][i], m));
          const float dp = bf16_round(dpt[j][i]);
          p[hh] = live ? __fdiv_rn(e, n) : 0.f;
          ds[hh] = live ? __fmul_rn(__fsub_rn(__fdiv_rn(dp, n), rr), e)
                        : 0.f;
        }
        const int at = qr * PLDS + 8 * j + 2 * t;
        *reinterpret_cast<uint32_t*>(Ps + at) = pack2(p[0], p[1]);
        uint32_t hi, mid, lo;
        split3(ds[0], ds[1], hi, mid, lo);
        *reinterpret_cast<uint32_t*>(Dt + at) = hi;
        *reinterpret_cast<uint32_t*>(Dt + TQ * PLDS + at) = mid;
        *reinterpret_cast<uint32_t*>(Dt + 2 * TQ * PLDS + at) = lo;
      }
    }
    __syncthreads();

    // this warp's 16 keys: dv += P^T . g, dk += ds^T . qs over the tile
    const int kw = 16 * warp;
#pragma unroll
    for (int qc = 0; qc < TQ / 16; ++qc) {
      // A = X^T of a (queries, keys) tile X: matrices l/8 at queries +8
      // for 2, 3 and keys +8 for 1, 3, each read transposed
      const int at = (16 * qc + (lane & 7) + (lane >> 4) * 8) * PLDS + kw +
                     ((lane >> 3) & 1) * 8;
      uint32_t a[4];
      ldsm_x4_trans(a, Ps + at);
      dot_rows<DP>(dva, a, Gs, 16 * qc);
      for (int term = 0; term < 3; ++term) {
        ldsm_x4_trans(a, Dt + term * TQ * PLDS + at);
        for (int qterm = 0; qterm < nt; ++qterm)
          dot_rows<DP>(dka, a, Qt + qterm * TQ * LDS, 16 * qc);
      }
    }
  }
  store_rows<DP>(dv + base, ld, k0 + 16 * warp, S, d, dva, 1.f);
  store_rows<DP>(dk + base, ld, k0 + 16 * warp, S, d, dka, 1.f);
}

// ------------------------------ fp32 FMAs -------------------------------

constexpr int F_WARPS = 8;
constexpr int F_THREADS = F_WARPS * 32;
constexpr int F_R = 4;                   // rows (or keys) of a warp
constexpr int F_ROWS = F_WARPS * F_R;    // of a block
constexpr int F_KT = 64;                 // keys (or queries) of a tile
constexpr int F_MAXJ = 4;                // head dims of a lane: d <= 128

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

// The dot of a (d values) and b, an FMA chain in column order: the one
// order every fp32 kernel takes for scores and dp.
__device__ __forceinline__ float dot_chain(const float* a, const float* b,
                                           int d) {
  float s = 0.f;
  for (int c = 0; c < d; ++c) s = __fmaf_rn(a[c], b[c], s);
  return s;
}

// Rows [r0, r0 + rows) of one head into a (rows, lds) fp32 tile, times
// `mul`; rows at or past S are zero.
__device__ __forceinline__ void load_f32(float* dst, int lds,
                                         const float* src, long long ld,
                                         int r0, int rows, int S, int d,
                                         float mul) {
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
    const int r = i / d, c = i % d;
    dst[r * lds + c] =
        r0 + r < S ? __fmul_rn(src[(long long)(r0 + r) * ld + c], mul) : 0.f;
  }
}

// grid (ceil(S / 32), batch * heads), 256 threads: a warp's 4 rows, a
// lane's keys lane and lane + 32 of each tile.
__global__ void __launch_bounds__(F_THREADS) fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, float* __restrict__ mo,
    float* __restrict__ no, int heads, int S, int d, float scale) {
  extern __shared__ float fsm[];
  const int kp = d + 1;
  float* Ks = fsm;                    // [F_KT][kp]
  float* Vs = Ks + F_KT * kp;         // [F_KT][kp]
  float* Qs = Vs + F_KT * kp;         // [F_ROWS][d], scaled
  float* Ps = Qs + F_ROWS * d;        // [F_ROWS][F_KT]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const long long ld = (long long)heads * d;
  const long long base = (long long)b * S * ld + (long long)h * d;
  const int row0 = blockIdx.x * F_ROWS + warp * F_R;
  load_f32(Qs, d, q + base, ld, blockIdx.x * F_ROWS, F_ROWS, S, d, scale);
  const float* qw = Qs + warp * F_R * d;
  float* pw = Ps + warp * F_R * F_KT;
  float m[F_R], n[F_R], acc[F_R][F_MAXJ];
#pragma unroll
  for (int rr = 0; rr < F_R; ++rr) {
    m[rr] = NEG;
    n[rr] = 0.f;
#pragma unroll
    for (int j = 0; j < F_MAXJ; ++j) acc[rr][j] = 0.f;
  }
#pragma unroll 1
  for (int sweep = 0; sweep < 2; ++sweep)
    for (int k0 = 0; k0 < S; k0 += F_KT) {
      __syncthreads();
      load_f32(Ks, kp, k + base, ld, k0, F_KT, S, d, 1.f);
      if (sweep == 1) load_f32(Vs, kp, v + base, ld, k0, F_KT, S, d, 1.f);
      __syncthreads();
      const bool la = k0 + lane < S, lb = k0 + lane + 32 < S;
#pragma unroll
      for (int rr = 0; rr < F_R; ++rr) {
        const float sa = la ? dot_chain(qw + rr * d, Ks + lane * kp, d) : NEG;
        const float sb =
            lb ? dot_chain(qw + rr * d, Ks + (lane + 32) * kp, d) : NEG;
        if (sweep == 0) {
          const float mx = fmaxf(m[rr], warp_max(fmaxf(sa, sb)));
          const float part = warp_sum(__fadd_rn(expf(__fsub_rn(sa, mx)),
                                                expf(__fsub_rn(sb, mx))));
          n[rr] = __fadd_rn(__fmul_rn(n[rr], expf(__fsub_rn(m[rr], mx))),
                            part);
          m[rr] = mx;
        } else {
          pw[rr * F_KT + lane] =
              la ? __fdiv_rn(expf(__fsub_rn(sa, m[rr])), n[rr]) : 0.f;
          pw[rr * F_KT + lane + 32] =
              lb ? __fdiv_rn(expf(__fsub_rn(sb, m[rr])), n[rr]) : 0.f;
        }
      }
      if (sweep == 0) continue;
      __syncwarp();
      for (int kk = 0; kk < F_KT; ++kk)
#pragma unroll
        for (int j = 0; j < F_MAXJ; ++j) {
          const int c = lane + 32 * j;
          if (c >= d) continue;
          const float vv = Vs[kk * kp + c];
#pragma unroll
          for (int rr = 0; rr < F_R; ++rr)
            acc[rr][j] = __fmaf_rn(pw[rr * F_KT + kk], vv, acc[rr][j]);
        }
      __syncwarp();
    }
#pragma unroll
  for (int rr = 0; rr < F_R; ++rr) {
    const int row = row0 + rr;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < F_MAXJ; ++j) {
      const int c = lane + 32 * j;
      if (c < d) o[base + (long long)row * ld + c] = acc[rr][j];
    }
    if (lane == 0) {
      mo[(long long)bh * S + row] = m[rr];
      no[(long long)bh * S + row] = n[rr];
    }
  }
}

// grid (ceil(S / 32), batch * heads), 256 threads: dq and r.
__global__ void __launch_bounds__(F_THREADS) bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ gr,
    const float* __restrict__ mo, const float* __restrict__ no,
    float* __restrict__ ro, float* __restrict__ dq, int heads, int S, int d,
    float scale) {
  extern __shared__ float fsm[];
  const int kp = d + 1;
  float* Ks = fsm;                 // [F_KT][kp]
  float* Vs = Ks + F_KT * kp;      // [F_KT][kp]
  float* Qs = Vs + F_KT * kp;      // [F_ROWS][d], scaled
  float* Gs = Qs + F_ROWS * d;     // [F_ROWS][d]
  float* Ds = Gs + F_ROWS * d;     // [F_ROWS][F_KT]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const long long ld = (long long)heads * d;
  const long long base = (long long)b * S * ld + (long long)h * d;
  const int row0 = blockIdx.x * F_ROWS + warp * F_R;
  load_f32(Qs, d, q + base, ld, blockIdx.x * F_ROWS, F_ROWS, S, d, scale);
  load_f32(Gs, d, gr + base, ld, blockIdx.x * F_ROWS, F_ROWS, S, d, 1.f);
  const float* qw = Qs + warp * F_R * d;
  const float* gw = Gs + warp * F_R * d;
  float* dw = Ds + warp * F_R * F_KT;
  float m[F_R], n[F_R], nis[F_R], r[F_R], acc[F_R][F_MAXJ];
#pragma unroll
  for (int rr = 0; rr < F_R; ++rr) {
    const int row = row0 + rr;
    m[rr] = row < S ? mo[(long long)bh * S + row] : 0.f;
    n[rr] = row < S ? no[(long long)bh * S + row] : 1.f;
    nis[rr] = __fdiv_rn(1.f, __fmul_rn(n[rr], n[rr]));
    r[rr] = 0.f;
#pragma unroll
    for (int j = 0; j < F_MAXJ; ++j) acc[rr][j] = 0.f;
  }
#pragma unroll 1
  for (int sweep = 0; sweep < 2; ++sweep) {
    for (int k0 = 0; k0 < S; k0 += F_KT) {
      __syncthreads();
      load_f32(Ks, kp, k + base, ld, k0, F_KT, S, d, 1.f);
      load_f32(Vs, kp, v + base, ld, k0, F_KT, S, d, 1.f);
      __syncthreads();
#pragma unroll
      for (int rr = 0; rr < F_R; ++rr)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int key = lane + 32 * hh;
          float val = 0.f;
          if (k0 + key < S) {
            const float s = dot_chain(qw + rr * d, Ks + key * kp, d);
            const float dp = dot_chain(gw + rr * d, Vs + key * kp, d);
            const float e = expf(__fsub_rn(s, m[rr]));
            if (sweep == 0)
              r[rr] = __fadd_rn(r[rr],
                                __fmul_rn(__fmul_rn(dp, nis[rr]), e));
            else
              val = __fmul_rn(__fsub_rn(__fdiv_rn(dp, n[rr]), r[rr]), e);
          }
          if (sweep == 1) dw[rr * F_KT + key] = val;
        }
      if (sweep == 0) continue;
      __syncwarp();
      for (int kk = 0; kk < F_KT; ++kk)
#pragma unroll
        for (int j = 0; j < F_MAXJ; ++j) {
          const int c = lane + 32 * j;
          if (c >= d) continue;
          const float kv = Ks[kk * kp + c];
#pragma unroll
          for (int rr = 0; rr < F_R; ++rr)
            acc[rr][j] = __fmaf_rn(dw[rr * F_KT + kk], kv, acc[rr][j]);
        }
      __syncwarp();
    }
    if (sweep == 0)
#pragma unroll
      for (int rr = 0; rr < F_R; ++rr) r[rr] = warp_sum(r[rr]);
  }
#pragma unroll
  for (int rr = 0; rr < F_R; ++rr) {
    const int row = row0 + rr;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < F_MAXJ; ++j) {
      const int c = lane + 32 * j;
      if (c < d)
        dq[base + (long long)row * ld + c] = __fmul_rn(acc[rr][j], scale);
    }
    if (lane == 0) ro[(long long)bh * S + row] = r[rr];
  }
}

// grid (ceil(S / 32), batch * heads), 256 threads: a warp's 4 keys, a
// lane's queries lane and lane + 32 of each tile.
__global__ void __launch_bounds__(F_THREADS) bwd_dkdv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ gr,
    const float* __restrict__ mo, const float* __restrict__ no,
    const float* __restrict__ ro, float* __restrict__ dk,
    float* __restrict__ dv, int heads, int S, int d, float scale) {
  extern __shared__ float fsm[];
  const int kp = d + 1;
  float* Kb = fsm;                  // [F_ROWS][d], the block's keys
  float* Vb = Kb + F_ROWS * d;      // [F_ROWS][d]
  float* Qs = Vb + F_ROWS * d;      // [F_KT][kp], scaled
  float* Gs = Qs + F_KT * kp;       // [F_KT][kp]
  float* St = Gs + F_KT * kp;       // [3][F_KT]: m, n, r
  float* Ps = St + 3 * F_KT;        // [F_ROWS][F_KT]
  float* Ds = Ps + F_ROWS * F_KT;   // [F_ROWS][F_KT]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const long long ld = (long long)heads * d;
  const long long base = (long long)b * S * ld + (long long)h * d;
  const int key0 = blockIdx.x * F_ROWS + warp * F_R;
  load_f32(Kb, d, k + base, ld, blockIdx.x * F_ROWS, F_ROWS, S, d, 1.f);
  load_f32(Vb, d, v + base, ld, blockIdx.x * F_ROWS, F_ROWS, S, d, 1.f);
  const float* kw = Kb + warp * F_R * d;
  const float* vw = Vb + warp * F_R * d;
  float* pw = Ps + warp * F_R * F_KT;
  float* dw = Ds + warp * F_R * F_KT;
  float dka[F_R][F_MAXJ], dva[F_R][F_MAXJ];
#pragma unroll
  for (int rr = 0; rr < F_R; ++rr)
#pragma unroll
    for (int j = 0; j < F_MAXJ; ++j) dka[rr][j] = dva[rr][j] = 0.f;
  for (int q0 = 0; q0 < S; q0 += F_KT) {
    __syncthreads();
    load_f32(Qs, kp, q + base, ld, q0, F_KT, S, d, scale);
    load_f32(Gs, kp, gr + base, ld, q0, F_KT, S, d, 1.f);
    for (int i = threadIdx.x; i < F_KT; i += blockDim.x) {
      const bool in = q0 + i < S;
      St[i] = in ? mo[(long long)bh * S + q0 + i] : 0.f;
      St[F_KT + i] = in ? no[(long long)bh * S + q0 + i] : 1.f;
      St[2 * F_KT + i] = in ? ro[(long long)bh * S + q0 + i] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < F_R; ++rr)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int qi = lane + 32 * hh;
        float p = 0.f, ds = 0.f;
        if (q0 + qi < S && key0 + rr < S) {
          const float s = dot_chain(Qs + qi * kp, kw + rr * d, d);
          const float dp = dot_chain(Gs + qi * kp, vw + rr * d, d);
          const float m = St[qi], n = St[F_KT + qi], r = St[2 * F_KT + qi];
          const float e = expf(__fsub_rn(s, m));
          p = __fdiv_rn(e, n);
          ds = __fmul_rn(__fsub_rn(__fdiv_rn(dp, n), r), e);
        }
        pw[rr * F_KT + qi] = p;
        dw[rr * F_KT + qi] = ds;
      }
    __syncwarp();
    for (int qq = 0; qq < F_KT; ++qq)
#pragma unroll
      for (int j = 0; j < F_MAXJ; ++j) {
        const int c = lane + 32 * j;
        if (c >= d) continue;
        const float gv = Gs[qq * kp + c], qv = Qs[qq * kp + c];
#pragma unroll
        for (int rr = 0; rr < F_R; ++rr) {
          dva[rr][j] = __fmaf_rn(pw[rr * F_KT + qq], gv, dva[rr][j]);
          dka[rr][j] = __fmaf_rn(dw[rr * F_KT + qq], qv, dka[rr][j]);
        }
      }
    __syncwarp();
  }
#pragma unroll
  for (int rr = 0; rr < F_R; ++rr) {
    const int row = key0 + rr;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < F_MAXJ; ++j) {
      const int c = lane + 32 * j;
      if (c < d) {
        dk[base + (long long)row * ld + c] = dka[rr][j];
        dv[base + (long long)row * ld + c] = dva[rr][j];
      }
    }
  }
}

// ------------------------------- launches -------------------------------

template <int DP>
static int fwd_tc(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                  float* m, float* n, int batch, int heads, int S, int d,
                  float scale, int nt, int vec, cudaStream_t stream) {
  const dim3 grid((S + TQ - 1) / TQ, batch * heads);
  const size_t smem = (3 * TQ + 2 * TK) * (DP + 8) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fwd_tc_kernel<DP><<<grid, TC_THREADS, smem, stream>>>(
      q, k, v, o, m, n, heads, S, d, scale, nt, vec);
  return (int)cudaGetLastError();
}

template <int DP>
static int bwd_tc(const bf16* q, const bf16* k, const bf16* v, const bf16* g,
                  const float* m, const float* n, float* r, bf16* dq,
                  bf16* dk, bf16* dv, int batch, int heads, int S, int d,
                  float scale, int nt, int vec, cudaStream_t stream) {
  const dim3 grid_q((S + TQ - 1) / TQ, batch * heads);
  const size_t smem_q = (4 * TQ + 2 * TK) * (DP + 8) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  bwd_dq_tc_kernel<DP><<<grid_q, TC_THREADS, smem_q, stream>>>(
      q, k, v, g, m, n, r, dq, heads, S, d, scale, nt, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_k((S + TK - 1) / TK, batch * heads);
  const size_t smem_k = (2 * TK + 4 * TQ) * (DP + 8) * sizeof(bf16) +
                        4 * TQ * PLDS * sizeof(bf16) + 3 * TQ * sizeof(float);
  err = cudaFuncSetAttribute(bwd_dkdv_tc_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_k);
  if (err != cudaSuccess) return (int)err;
  bwd_dkdv_tc_kernel<DP><<<grid_k, TC_THREADS, smem_k, stream>>>(
      q, k, v, g, m, n, r, dk, dv, heads, S, d, scale, nt, vec);
  return (int)cudaGetLastError();
}

extern "C" {

// The widest head the kernels take.
int flash_trainable_max_head_dim() { return 32 * F_MAXJ; }

// q, k, v, o: contiguous (batch, S, heads, d), all bf16 (is_f32 0) or all
// fp32; m, n: (batch, heads, S) fp32, the row max and row sum. nt: the
// bf16 terms of fp32(q) * scale (1 where scale is a power of two, else
// 3); vec: 16-byte loads (d % 8 == 0, every operand 16-byte aligned).
int mha_flash_trainable_fwd(const void* q, const void* k, const void* v,
                            void* o, float* m, float* n, int batch,
                            int heads, int S, int d, float scale, int is_f32,
                            int nt, int vec, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f32) {
    const dim3 grid((S + F_ROWS - 1) / F_ROWS, batch * heads);
    const size_t smem =
        sizeof(float) * (2 * F_KT * (d + 1) + F_ROWS * (d + F_KT));
    cudaError_t err = cudaFuncSetAttribute(
        fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    fwd_f32_kernel<<<grid, F_THREADS, smem, s>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, m, n,
        heads, S, d, scale);
    return (int)cudaGetLastError();
  }
#define FWD_TC(DP)                                                          \
  return fwd_tc<DP>((const bf16*)q, (const bf16*)k, (const bf16*)v,         \
                    (bf16*)o, m, n, batch, heads, S, d, scale, nt, vec, s)
  if (d <= 32) FWD_TC(32);
  if (d <= 64) FWD_TC(64);
  FWD_TC(128);
#undef FWD_TC
}

// g, dq, dk, dv: contiguous (batch, S, heads, d) in the inputs' type; m, n
// from the forward; r: a (batch, heads, S) fp32 scratch the dq kernel
// writes and the dk/dv kernel reads. Two launches, in that order.
int mha_flash_trainable_bwd(const void* q, const void* k, const void* v,
                            const void* g, const float* m, const float* n,
                            float* r, void* dq, void* dk, void* dv,
                            int batch, int heads, int S, int d, float scale,
                            int is_f32, int nt, int vec, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f32) {
    const dim3 grid((S + F_ROWS - 1) / F_ROWS, batch * heads);
    const size_t smem_q =
        sizeof(float) * (2 * F_KT * (d + 1) + F_ROWS * (2 * d + F_KT));
    cudaError_t err = cudaFuncSetAttribute(
        bwd_dq_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_q);
    if (err != cudaSuccess) return (int)err;
    bwd_dq_f32_kernel<<<grid, F_THREADS, smem_q, s>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)g,
        m, n, r, (float*)dq, heads, S, d, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t smem_k =
        sizeof(float) * (2 * F_ROWS * d + 2 * F_KT * (d + 1) + 3 * F_KT +
                         2 * F_ROWS * F_KT);
    err = cudaFuncSetAttribute(bwd_dkdv_f32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_k);
    if (err != cudaSuccess) return (int)err;
    bwd_dkdv_f32_kernel<<<grid, F_THREADS, smem_k, s>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)g,
        m, n, r, (float*)dk, (float*)dv, heads, S, d, scale);
    return (int)cudaGetLastError();
  }
#define BWD_TC(DP)                                                           \
  return bwd_tc<DP>((const bf16*)q, (const bf16*)k, (const bf16*)v,          \
                    (const bf16*)g, m, n, r, (bf16*)dq, (bf16*)dk, (bf16*)dv, \
                    batch, heads, S, d, scale, nt, vec, s)
  if (d <= 32) BWD_TC(32);
  if (d <= 64) BWD_TC(64);
  BWD_TC(128);
#undef BWD_TC
}

}  // extern "C"
