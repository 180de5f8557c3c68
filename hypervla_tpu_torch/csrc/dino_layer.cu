// DINOv2 serving trunk for Hopper (sm_90a): the kernels one transformer
// layer of the bs=1 serving trunk is made of.
//
// Replaces the Pallas TPU kernel hypervla_tpu/ops/dino_layer.py::
// dino_layers_serving (body `_kernel`), and computes what its shared
// numeric spec `_serving_layer_body` says: LayerNorm statistics and softmax
// in fp32, every dot as bf16 operands with an fp32 sum rounded once to bf16,
// biases added in bf16, exact GELU evaluated in fp32, LayerScale residuals
// in bf16. The wrapper (hypervla_tpu_torch/ops/dino_layer.py) launches, per
// layer: LN1, GEMM (QKV), attention, GEMM (out-proj + residual), LN2,
// GEMM (fc1 + GELU), GEMM (fc2 + residual).
//
// What bounds the trunk on this card: one step reads the ~170 MB of stacked
// bf16 weights once against ~44 GFLOP (2 x 86M params x 257 tokens), about
// 260 FLOP per byte, under the H100's ~295 FLOP/byte ridge: the floor is the
// weight read (~51 us at 3.35 TB/s). The GEMM is a pipelined `wgmma` kernel
// (see its note below), the attention runs its three products on the bf16
// tensor cores (`mma.sync`, its note below), and the LayerNorm holds a row in
// the registers of one warp (16-byte loads, shuffles, no block barrier).
//
// The training layer (hypervla_tpu_torch/ops/dino_layer_train.py) and the
// training LayerNorm (ops/layer_norm.py) launch the same LayerNorm and GEMM
// at M = B*S rows: for them the LayerNorm also takes fp32 rows, and the
// GEMM has a second output, a no-bias form and an fp32 output (below).
//
// Plain C interface (loaded with ctypes). Every entry point launches on the
// given stream and returns cudaGetLastError().

#include "wgmma_tma.cuh"
#include "mma_sync.cuh"
#include "row_vec.cuh"

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 tobf(float v) { return __float2bfloat16_rn(v); }
// round an fp32 value to the nearest bf16 and back
__device__ __forceinline__ float rbf(float v) { return bf(tobf(v)); }

using row::warp_sum;

// ------------------------------- LayerNorm -------------------------------
// flax fast variance: var = max(E[x^2] - mu^2, 0), then ((x - mu) *
// rsqrt(var + eps)) * scale + bias in fp32, rounded once to the input's type
// T (bf16 in the trunks; fp32 too for the training LayerNorm of
// ops/layer_norm.py, whose forward this is).
//
// What bounds it: bytes (a row is read once and written once; 8 operations a
// value). `layer_norm_rows_kernel` is the kernel of every width that is a
// multiple of 8 up to 256 CH (the wrapper chooses, ops/dino_layer.py::
// layer_norm_plan): a warp owns a row and holds it in registers as CH chunks
// of eight values a lane (row_vec.cuh), so the row is read once by 16-byte
// loads, both sums of a row are warp shuffles and no barrier stands in the
// row loop; scale and bias are read once per warp and kept; a warp walks rows
// gw, gw + (warps of the grid), ... and has the next row's loads in flight
// while it computes this one. `layer_norm_kernel` (one block per row, scalar
// loads, two block barriers) stays for the other widths.

// grid: any number of blocks of 32 * warps threads.
template <typename T, int CH>
__global__ void __launch_bounds__(256) layer_norm_rows_kernel(
    const T* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ bias, T* __restrict__ out, int rows, int d,
    float eps) {
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int stride = gridDim.x * warps;
  const int chunks = d >> 3;
  float sc[CH][8], bi[CH][8];
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = lane + 32 * i;
    if (c < chunks) {
      row::load8(sc[i], scale + 8 * c);
      row::load8(bi[i], bias + 8 * c);
    }
  }
  int r = blockIdx.x * warps + (threadIdx.x >> 5);
  row::Raw<T> cur[CH], nxt[CH];
  if (r < rows) {
#pragma unroll
    for (int i = 0; i < CH; ++i)
      if (lane + 32 * i < chunks)
        row::load_raw(cur[i], x + (size_t)r * d + 8 * (lane + 32 * i));
  }
  for (; r < rows; r += stride) {
    if (r + stride < rows) {
#pragma unroll
      for (int i = 0; i < CH; ++i)
        if (lane + 32 * i < chunks)
          row::load_raw(nxt[i],
                        x + (size_t)(r + stride) * d + 8 * (lane + 32 * i));
    }
    float v[CH][8];
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      if (lane + 32 * i < chunks) {
        row::widen(v[i], cur[i]);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          s += v[i][k];
          s2 += v[i][k] * v[i][k];
        }
      }
    }
    row::warp_sum2(s, s2);
    const float mu = s / (float)d;
    const float var = fmaxf(s2 / (float)d - mu * mu, 0.f);
    const float rs = rsqrtf(var + eps);
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      if (lane + 32 * i < chunks) {
        float y[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float n = (v[i][k] - mu) * rs;
          y[k] = n * sc[i][k] + bi[i][k];
        }
        row::store8(out + (size_t)r * d + 8 * (lane + 32 * i), y);
      }
    }
#pragma unroll
    for (int i = 0; i < CH; ++i) cur[i] = nxt[i];
  }
}

// The kernel of the other widths: one block per row.
constexpr int LN_THREADS = 256;

__device__ __forceinline__ float ln_load(const bf16* p) { return bf(*p); }
__device__ __forceinline__ float ln_load(const float* p) { return *p; }
__device__ __forceinline__ void ln_store(bf16* p, float v) { *p = tobf(v); }
__device__ __forceinline__ void ln_store(float* p, float v) { *p = v; }

template <typename T>
__global__ void __launch_bounds__(LN_THREADS) layer_norm_kernel(
    const T* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ bias, T* __restrict__ out, int d, float eps) {
  const T* xr = x + (size_t)blockIdx.x * d;
  T* orow = out + (size_t)blockIdx.x * d;
  float s = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < d; i += LN_THREADS) {
    const float v = ln_load(xr + i);
    s += v;
    s2 += v * v;
  }
  __shared__ float red[2][LN_THREADS / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  s = warp_sum(s);
  s2 = warp_sum(s2);
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    s = lane < LN_THREADS / 32 ? red[0][lane] : 0.f;
    s2 = lane < LN_THREADS / 32 ? red[1][lane] : 0.f;
    s = warp_sum(s);
    s2 = warp_sum(s2);
    if (lane == 0) {
      red[0][0] = s;
      red[1][0] = s2;
    }
  }
  __syncthreads();
  const float mu = red[0][0] / (float)d;
  const float var = fmaxf(red[1][0] / (float)d - mu * mu, 0.f);
  const float rs = rsqrtf(var + eps);
  for (int i = threadIdx.x; i < d; i += LN_THREADS) {
    const float y = (ln_load(xr + i) - mu) * rs;
    ln_store(orow + i, y * scale[i] + bias[i]);
  }
}

// ---------------------------- GEMM + epilogue ----------------------------
// out[M, N] = epilogue(A[M, K] @ B), A row-major (lda), B either [K, N]
// row-major (ldb) or, with TRANS_B, stored as B^T [N, K] row-major (ldb) —
// fc2 keeps W2^T and contracts on its dim 1. bf16 operands, fp32 sum.
// Epilogue, in order: round the fp32 sum to bf16; add bf16(bias) where a
// bias is given; then
//   EPI_NONE:     nothing
//   EPI_GELU:     x * 0.5 * (1 + erf(x / sqrt 2)) in fp32, rounded to bf16
//   EPI_RESIDUAL: residual + bf16(layer_scale) * y, each op rounded to bf16
//   EPI_F32:      none of the above: the fp32 sum itself, written as fp32
//                 (the layer backward's LayerNorm cotangents)
// With out2, EPI_GELU and EPI_RESIDUAL also write y as it was before the
// GELU or the LayerScale multiply: the residuals the training layer saves
// (ops/dino_layer_train.py), so that the saving forward and the plain one
// are the same arithmetic.
//
// What bounds it: at the training shape (M = 16448) the product is bound by
// operations (233 GFLOP a layer forward), at the serving shape (M = 257) by
// the weight read. The design is a Hopper one: the product runs on `wgmma`
// (m64nNk16, bf16 operands from shared memory, the fp32 sum in registers), fed
// by a ring of shared-memory stages that 16-byte `cp.async` groups (or TMA)
// fill while earlier stages are multiplied. A stage holds a BM x 64 tile of A
// and a 64 x BN tile of B in the 128-byte-swizzled layout the `wgmma`
// descriptor names: rows of 128 bytes, the 16-byte chunk c of row r stored at
// chunk c ^ (r & 7). A, and B with TRANS_B, are K-major (a row is 64 values of
// K); B as [K, N] is MN-major (a row is 64 values of N at one k, one 8 KB
// sub-tile per 64 columns) and the descriptor's transpose bit reads it as it
// lies, so neither form needs a transposed copy. Rows past M and columns past
// K are zero-filled (`cp.async` with a source size of 0; TMA clips its box).
// The epilogue starts from the accumulator registers: thread (warp w, lane 4g
// + t) of a warpgroup holds rows 16w + g and 16w + g + 8 and, for each
// 8-column group j, columns 8j + 2t and 8j + 2t + 1. The fp32 sums are staged
// once through the (by then free) ring so that bias, layer_scale, residual,
// out and out2 are read and written 16 bytes a thread along rows.
//
// This kernel's tile is 64 x 64 (one warpgroup, four stages): it serves
// small M, where the number of blocks matters more than the tile, and any N
// that is no multiple of 256; there K may be split over gridDim.z into fp32
// partial sums that `splitk_finish_kernel` adds in a fixed order before the
// same epilogue (no atomics; the sum is still rounded once). Large M with N
// a multiple of 256 (every product of the training layer) takes
// `gemm_tma_kernel` below: the same descriptors and epilogue on a 128 x 256
// tile, the ring filled by TMA from a producer warp. What is still open: a
// persistent grid that overlaps a tile's epilogue with the next tile's
// products (with K = 768 the epilogue is as long as the 12 k-tiles), and
// TMA stores.

constexpr int BK = 64;  // a stage's depth: one 128-byte swizzled row
enum { EPI_NONE = 0, EPI_GELU = 1, EPI_RESIDUAL = 2, EPI_F32 = 3 };


// The epilogue of eight neighbouring columns (n a multiple of 8) of row m,
// from their fp32 sums v: 16-byte loads and stores throughout.
template <int EPI>
__device__ __forceinline__ void gemm_epilogue(
    const float (&v)[8], int m, int n, int N, const float* __restrict__ bias,
    const bf16* __restrict__ residual, const float* __restrict__ layer_scale,
    void* __restrict__ out, bf16* __restrict__ out2) {
  const size_t o = (size_t)m * N + n;
  if constexpr (EPI == EPI_F32) {
    float4* dst = reinterpret_cast<float4*>(static_cast<float*>(out) + o);
    dst[0] = make_float4(v[0], v[1], v[2], v[3]);
    dst[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    float y[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) y[i] = rbf(v[i]);
    if (bias) {
      float b[8];
      load8(b, bias + n);
#pragma unroll
      for (int i = 0; i < 8; ++i) y[i] = rbf(y[i] + rbf(b[i]));
    }
    if (EPI != EPI_NONE && out2) store8(out2 + o, y);
    if (EPI == EPI_GELU) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        y[i] = y[i] * (0.5f * (1.f + erff(y[i] * 0.70710678118654752f)));
    } else if (EPI == EPI_RESIDUAL) {
      float ls[8];
      load8(ls, layer_scale + n);
      const uint4 r = *reinterpret_cast<const uint4*>(residual + o);
      const uint32_t rw[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 rr =
            *reinterpret_cast<const __nv_bfloat162*>(&rw[i]);
        y[2 * i] = __low2float(rr) + rbf(rbf(ls[2 * i]) * y[2 * i]);
        y[2 * i + 1] =
            __high2float(rr) + rbf(rbf(ls[2 * i + 1]) * y[2 * i + 1]);
      }
    }
    store8(static_cast<bf16*>(out) + o, y);
  }
}

// gemm_kernel's tile: 64 x 64 outputs a block, one warpgroup, four stages
// of a 64-row A tile and a 64-column B tile each.
constexpr int BM = 64, BN = 64, GEMM_THREADS = 128, STAGES = 4;
constexpr int A_BYTES = BM * 128, B_BYTES = BN * 128;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
// 1 KB of slack to align the ring to the swizzle's 1024-byte period
constexpr int GEMM_SMEM_BYTES = STAGES * STAGE_BYTES + 1024;

// grid (N / BN, ceil(M / BM), splits). With SPLIT the block multiplies its
// share of the k-tiles and writes the fp32 sums to partial[z][M][N].
template <bool TRANS_B, int EPI, bool SPLIT>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(
    const bf16* __restrict__ A, int lda, const bf16* __restrict__ B, int ldb,
    const float* __restrict__ bias, const bf16* __restrict__ residual,
    const float* __restrict__ layer_scale, void* __restrict__ out,
    bf16* __restrict__ out2, float* __restrict__ partial, int M, int N,
    int K) {
  extern __shared__ unsigned char gemm_smem[];
  const uint32_t ring = (smem_u32(gemm_smem) + 1023u) & ~1023u;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_tiles = (K + BK - 1) / BK;
  const int my_tiles = SPLIT ? k_tiles / (int)gridDim.z : k_tiles;
  const int first_tile = SPLIT ? (int)blockIdx.z * my_tiles : 0;

  auto load_stage = [&](int stage, int tile) {
    const uint32_t sa = ring + stage * STAGE_BYTES;
    const uint32_t sb = sa + A_BYTES;
    const int k0 = tile * BK;
    for (int v = tid; v < BM * 8; v += GEMM_THREADS) {
      const int r = v >> 3, c = v & 7;
      const bool in = m0 + r < M && k0 + c * 8 < K;
      const bf16* src = in ? A + (size_t)(m0 + r) * lda + k0 + c * 8 : A;
      cp_async16(sa + r * 128 + ((c ^ (r & 7)) << 4), src, in);
    }
    if (TRANS_B) {
      for (int v = tid; v < BN * 8; v += GEMM_THREADS) {
        const int r = v >> 3, c = v & 7;
        const bool in = k0 + c * 8 < K;
        const bf16* src = in ? B + (size_t)(n0 + r) * ldb + k0 + c * 8 : B;
        cp_async16(sb + r * 128 + ((c ^ (r & 7)) << 4), src, in);
      }
    } else {
      for (int v = tid; v < BK * 8; v += GEMM_THREADS) {
        const int r = v >> 3, c = v & 7;
        const bool in = k0 + r < K;
        const bf16* src = in ? B + (size_t)(k0 + r) * ldb + n0 + c * 8 : B;
        cp_async16(sb + r * 128 + ((c ^ (r & 7)) << 4), src, in);
      }
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < my_tiles) load_stage(s, first_tile + s);
    cp_async_commit();
  }
  for (int i = 0; i < my_tiles; ++i) {
    cp_async_wait<STAGES - 2>();
    // the copies above went through the generic proxy; wgmma reads shared
    // memory through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    // the stage tile i - 1 was multiplied from is free: every warp waited
    // for its wgmma before this barrier
    if (i + STAGES - 1 < my_tiles)
      load_stage((i + STAGES - 1) % STAGES, first_tile + i + STAGES - 1);
    cp_async_commit();

    const uint32_t sa = ring + (i % STAGES) * STAGE_BYTES;
    // K-major tiles: 1024 bytes from one 8-row group to the next; the
    // MN-major B tile: the same from one 8-k group to the next
    const uint64_t da = wgmma_desc(sa, 16, 1024);
    const uint64_t db = wgmma_desc(sa + A_BYTES, TRANS_B ? 16 : 8192, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      // a k-step is 32 bytes along a K-major row, 16 rows of an MN-major
      // tile; the descriptor's address is in 16-byte units
      wgmma_k16<0, TRANS_B ? 0 : 1>(acc, da + kk * 2,
                                 db + (TRANS_B ? kk * 2 : kk * 128),
                                 (i | kk) != 0);
    wgmma_commit();
    wgmma_wait<0>();
  }

  // The sums go through shared memory (the ring is free now) so that
  // global memory sees 16-byte accesses along rows.
  constexpr int LDC = BN + 4;  // fp32 row of the staged tile
  float* Cs = reinterpret_cast<float*>(gemm_smem +
                                       (ring - smem_u32(gemm_smem)));
  __syncthreads();
  {
    const int warp = tid >> 5, lane = tid & 31;
    float* crow = Cs + (warp * 16 + (lane >> 2)) * LDC + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<float2*>(crow + 8 * j) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(crow + 8 * LDC + 8 * j) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  __syncthreads();
  for (int v = tid; v < BM * (BN / 8); v += GEMM_THREADS) {
    const int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
    const int m = m0 + r, n = n0 + c;
    if (m >= M) break;
    float sums[8];
    load8(sums, Cs + r * LDC + c);
    if (SPLIT)
      gemm_epilogue<EPI_F32>(sums, m, n, N, nullptr, nullptr, nullptr,
                             partial + (size_t)blockIdx.z * M * N, nullptr);
    else
      gemm_epilogue<EPI>(sums, m, n, N, bias, residual, layer_scale, out,
                         out2);
  }
}

// One thread per eight columns: adds the splits' partial sums in order,
// then the epilogue.
template <int EPI>
__global__ void __launch_bounds__(256) splitk_finish_kernel(
    const float* __restrict__ partial, int splits,
    const float* __restrict__ bias, const bf16* __restrict__ residual,
    const float* __restrict__ layer_scale, void* __restrict__ out,
    bf16* __restrict__ out2, int M, int N) {
  const size_t first = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 8;
  const size_t total = (size_t)M * N;
  if (first >= total) return;
  float sums[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < splits; ++s) {
    float part[8];
    load8(part, partial + s * total + first);
#pragma unroll
    for (int i = 0; i < 8; ++i) sums[i] += part[i];
  }
  gemm_epilogue<EPI>(sums, (int)(first / N), (int)(first % N), N, bias,
                     residual, layer_scale, out, out2);
}

// The large-M kernel: a 128 x 256 tile, one producer warpgroup of which one
// thread keeps TMA loads of the next k-tiles in flight, two consumer
// warpgroups that multiply the tiles that have arrived (m64n256k16, each
// 64 x 256 of the tile, 128 accumulator registers a thread; `setmaxnreg`
// moves the producer's registers to them). TMA writes the same 128-byte
// swizzle the descriptors name, zero-fills rows past M and columns past K,
// and reports to the stage's `full` barrier; a consumer warp releases a
// stage to its `empty` barrier once the wgmma that read it has completed,
// one k-tile behind the one it has just issued. The epilogue is the one of
// gemm_kernel, staged through the ring by the 256 consumer threads.

constexpr int TMA_BM = 128, TMA_BN = 256, TMA_STAGES = 4;
constexpr int TMA_A_BYTES = TMA_BM * 128, TMA_B_BYTES = TMA_BN * 128;
constexpr int TMA_STAGE_BYTES = TMA_A_BYTES + TMA_B_BYTES;
// ring, 1 KB to align it, 2 x TMA_STAGES 8-byte barriers
constexpr int TMA_SMEM_BYTES = TMA_STAGES * TMA_STAGE_BYTES + 1024 + 64;

// grid (N / 256, ceil(M / 128)); 384 threads.
template <bool TRANS_B, int EPI>
__global__ void __launch_bounds__(384, 1) gemm_tma_kernel(
    const __grid_constant__ CUtensorMap map_a,
    const __grid_constant__ CUtensorMap map_b,
    const float* __restrict__ bias, const bf16* __restrict__ residual,
    const float* __restrict__ layer_scale, void* __restrict__ out,
    bf16* __restrict__ out2, int M, int N, int K) {
  extern __shared__ unsigned char gemm_smem[];
  const uint32_t ring = (smem_u32(gemm_smem) + 1023u) & ~1023u;
  const uint32_t full = ring + TMA_STAGES * TMA_STAGE_BYTES;
  const uint32_t empty = full + 8 * TMA_STAGES;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.y * TMA_BM, n0 = blockIdx.x * TMA_BN;
  const int k_tiles = (K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < TMA_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);   // the producer's expect_tx
      mbar_init(empty + 8 * s, 8);  // one lane of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      for (int i = 0; i < k_tiles; ++i) {
        const int s = i % TMA_STAGES;
        // the stage's previous tile (i - TMA_STAGES) has been multiplied
        if (i >= TMA_STAGES)
          mbar_wait(empty + 8 * s, (i / TMA_STAGES - 1) & 1);
        const uint32_t sa = ring + s * TMA_STAGE_BYTES;
        const uint32_t sb = sa + TMA_A_BYTES;
        mbar_expect_tx(full + 8 * s, TMA_STAGE_BYTES);
        tma_load_2d(sa, &map_a, full + 8 * s, i * BK, m0);
        if (TRANS_B) {
          tma_load_2d(sb, &map_b, full + 8 * s, i * BK, n0);
        } else {
#pragma unroll
          for (int j = 0; j < TMA_BN / 64; ++j)
            tma_load_2d(sb + j * 8192, &map_b, full + 8 * s, n0 + 64 * j,
                        i * BK);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float acc[TMA_BN / 2];
#pragma unroll
    for (int i = 0; i < TMA_BN / 2; ++i) acc[i] = 0.f;
    const int lane = tid & 31;
    for (int i = 0; i < k_tiles; ++i) {
      const int s = i % TMA_STAGES;
      mbar_wait(full + 8 * s, (i / TMA_STAGES) & 1);
      const uint32_t sa = ring + s * TMA_STAGE_BYTES;
      const uint64_t da = wgmma_desc(sa + wg * (64 * 128), 16, 1024);
      const uint64_t db = TRANS_B
                              ? wgmma_desc(sa + TMA_A_BYTES, 16, 1024)
                              : wgmma_desc(sa + TMA_A_BYTES, 8192, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_k16<0, TRANS_B ? 0 : 1>(acc, da + kk * 2,
                                   db + (TRANS_B ? kk * 2 : kk * 128),
                                   (i | kk) != 0);
      wgmma_commit();
      // tile i - 1's wgmma has completed: its stage may be refilled
      wgmma_wait<1>();
      if (i > 0 && lane == 0) mbar_arrive(empty + 8 * ((i - 1) % TMA_STAGES));
    }
    wgmma_wait<0>();

    constexpr int LDC = TMA_BN + 4;  // fp32 row of the staged tile
    float* Cs = reinterpret_cast<float*>(gemm_smem +
                                         (ring - smem_u32(gemm_smem)));
    // barrier 1: the 256 consumer threads only
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    {
      const int warp = (tid >> 5) & 3;
      float* crow = Cs + (wg * 64 + warp * 16 + (lane >> 2)) * LDC +
                    2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < TMA_BN / 8; ++j) {
        *reinterpret_cast<float2*>(crow + 8 * j) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(crow + 8 * LDC + 8 * j) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    for (int v = tid; v < TMA_BM * (TMA_BN / 8); v += 256) {
      const int r = v / (TMA_BN / 8), c = (v % (TMA_BN / 8)) * 8;
      if (m0 + r >= M) break;
      float sums[8];
      load8(sums, Cs + r * LDC + c);
      gemm_epilogue<EPI>(sums, m0 + r, n0 + c, N, bias, residual, layer_scale,
                         out, out2);
    }
  }
}

// ------------------------------- Attention -------------------------------
// Softmax attention of one head over all S tokens of a fused (S, 3 * hidden)
// [q | k | v] buffer, head dim 64, no mask, at the rounding points of the
// TPU kernel's body: q2 = bf16(q * 0.125); s = bf16(fp32 sum q2.k); fp32
// softmax over the whole row; P = bf16(e / sum); o = bf16(fp32 sum P.v).
// P is rounded after the division by the whole row's sum, so a streaming
// softmax that rescales a running output would be another function: the
// row's sum is known before P is formed.
//
// What bounds it: neither bytes (0.6 MB) nor operations (0.2 GFLOP): at
// bs=1 the 12 heads cannot fill 132 multiprocessors with more than one small
// block each, and the time is one block's serial walk over its head. So the
// design cuts that walk: both products on the bf16 tensor cores
// (`mma.sync.m16n8k16`, fp32 sum; operands by `ldmatrix` from shared-memory
// rows padded to 72 values, mma_sync.cuh), a warp owning 16 query rows, its
// score accumulator being, register for register, the A operand of P.V, so P
// never passes through shared memory. K, then V, of the head arrive by
// 16-byte `cp.async` in two groups: V lands while the scores and the softmax
// run. Rows past S are zero-filled in shared memory; the key mask is applied
// on the key tiles that reach past S only; q is read straight from the fused
// buffer with its row stride. The grid is (heads, ceil(S / (16 * row
// warps))) blocks, chosen by the wrapper (ops/dino_layer.py::
// attention_warps): two row warps at the serving shape, 12 x 9 = 108 blocks,
// one a multiprocessor.
//
// What a block spends most on is not the `mma` but the fp32 softmax around
// them (a rounding, a maximum, an `expf`, a sum, a division and a packing per
// score). So every 16 query rows go to ATT_KEY_WARPS warps, each a contiguous
// quarter of the keys: a warp keeps its 16 x 80 scores in its accumulators,
// so q.k^T is computed once with one `expf` an entry; the warps exchange
// their row maxima and row sums through shared memory (the sums added in warp
// order), multiply their quarter of P by V, and leave fp32 partial outputs
// that are added in warp order and rounded once. That holds rows of up to
// ATT_MAX_SEQ = 16 * ATT_KEY_WARPS * ATT_HOLD_CHUNKS = 320 keys (the serving
// trunk's 257); the wrapper refuses longer ones. (A warp per 16 rows over all
// keys that computes the scores twice, as the training attention's forward
// does, takes any length at twice the time at S = 257: not kept.)

constexpr int ATT_KEY_WARPS = 4;    // warps that share 16 query rows
constexpr int ATT_HOLD_CHUNKS = 5;  // 16-key chunks of scores a warp holds
constexpr int ATT_MAX_SEQ = 16 * ATT_KEY_WARPS * ATT_HOLD_CHUNKS;
constexpr int ATT_LDO = HEAD_DIM + 4;  // fp32 row of a partial output tile

// Rounds the scores of the 8-key tile at column c0 to bf16, masks the keys
// at or past S (only a tile that reaches past S pays for the comparison).
__device__ __forceinline__ void round_and_mask(float (&s)[4], int c0, int S) {
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = rbf(s[i]);
  if (c0 + 8 > S) {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (c0 + 2 * t + (i & 1) >= S) s[i] = -INFINITY;
  }
}

// Shared memory after K and V: the key warps' partial outputs, then their
// row maxima and row sums.
__host__ __device__ constexpr int att_smem_bytes(int seq, int row_warps) {
  return 2 * round_up(seq, 16) * HEAD_LDS * (int)sizeof(bf16) +
         row_warps * ATT_KEY_WARPS * 16 * (ATT_LDO + 2) * (int)sizeof(float);
}

// grid (heads, ceil(S / (16 * row_warps))); 32 * ATT_KEY_WARPS * row_warps
// threads (row_warps <= 4): warp w is key warp w % 4 of row warp w / 4.
// S <= ATT_MAX_SEQ.
__global__ void __launch_bounds__(512, 1) attention_kernel(
    const bf16* __restrict__ qkv, bf16* __restrict__ out, int S,
    int hidden) {
  extern __shared__ __align__(16) unsigned char att_smem[];
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rw = threadIdx.x >> 7, kw = (threadIdx.x >> 5) & 3;
  const int row_warps = blockDim.x >> 7;
  const int S16 = round_up(S, 16);
  bf16* Ks = reinterpret_cast<bf16*>(att_smem);
  bf16* Vs = Ks + (size_t)S16 * HEAD_LDS;
  const long ld = 3 * (long)hidden;
  const bf16* q = qkv + blockIdx.x * HEAD_DIM;
  load_head_async(Ks, q + hidden, S, S16, ld);
  cp_async_commit();
  load_head_async(Vs, q + 2 * hidden, S, S16, ld);
  cp_async_commit();
  const int m0 = (blockIdx.y * row_warps + rw) * 16;  // the row warp's rows
  uint32_t qa[4][4];
  load_a_rows_scaled(qa, q, ld, m0, S, 0.125f);
  float* part = reinterpret_cast<float*>(Vs + (size_t)S16 * HEAD_LDS);
  float* maxes = part + row_warps * ATT_KEY_WARPS * 16 * ATT_LDO;
  float* sums = maxes + row_warps * ATT_KEY_WARPS * 16;
  const int mine = (rw * ATT_KEY_WARPS + kw) * 16;  // this warp's 16 rows
  const int all = rw * ATT_KEY_WARPS * 16;          // of its key warp 0
  // this warp's keys [c0, c1): a contiguous share of the 16-key chunks
  const int per = (S16 / 16 + ATT_KEY_WARPS - 1) / ATT_KEY_WARPS;
  const int c0 = kw * per * 16;
  const int c1 = min(S16, c0 + per * 16);
  cp_async_wait<1>();  // K has landed; V is still in flight
  __syncthreads();

  // s[j]: the warp's 16 rows against keys [c0 + 8j, c0 + 8j + 8); entries
  // [0], [1] of row g, [2], [3] of row g + 8. A share that ends before S
  // holds a key below S, so its maximum is finite; an empty share leaves
  // -inf and 0.
  float s[2 * ATT_HOLD_CHUNKS][4];
  rows_dot_chunk<ATT_HOLD_CHUNKS>(s, qa, Ks, c0, c1);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 2 * ATT_HOLD_CHUNKS; ++j) {
    if (c0 + 8 * j < c1) {
      round_and_mask(s[j], c0 + 8 * j, S);
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], s[j][i]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    if (t == 0) maxes[mine + g + 8 * r] = mx[r];
  }
  __syncthreads();
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = maxes[all + g + 8 * r];
#pragma unroll
    for (int k = 1; k < ATT_KEY_WARPS; ++k)
      mx[r] = fmaxf(mx[r], maxes[all + 16 * k + g + 8 * r]);
  }
#pragma unroll
  for (int j = 0; j < 2 * ATT_HOLD_CHUNKS; ++j) {
    if (c0 + 8 * j < c1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[j][i] = expf(s[j][i] - mx[i >> 1]);
        sum[i >> 1] += s[j][i];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] = quad_sum(sum[r]);
    if (t == 0) sums[mine + g + 8 * r] = sum[r];
  }
  cp_async_wait<0>();
  __syncthreads();  // the row sums are written and V has landed
  float rcp[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] = sums[all + g + 8 * r];
#pragma unroll
    for (int k = 1; k < ATT_KEY_WARPS; ++k)
      sum[r] += sums[all + 16 * k + g + 8 * r];
    rcp[r] = __frcp_rn(sum[r]);
  }

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < ATT_HOLD_CHUNKS; ++kk) {
    if (c0 + 16 * kk < c1) {
      uint32_t p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // p[0], p[1]: rows g, g + 8 of tile 2kk; p[2], p[3]: of tile 2kk + 1
        const float(&e)[4] = s[2 * kk + (i >> 1)];
        const int r = i & 1;
        p[i] = pack2(div_by(e[2 * r], sum[r], rcp[r]),
                     div_by(e[2 * r + 1], sum[r], rcp[r]));
      }
      step_dot_rows(acc, p, Vs, c0 + 16 * kk);
    }
  }
  // the key warps' partial outputs, added in warp order, rounded once:
  // thread 32 kw + lane of a row warp takes 8 neighbouring outputs
  {
    float* tile = part + (size_t)mine * ATT_LDO + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float2*>(tile + g * ATT_LDO + 8 * j) =
          make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(tile + (g + 8) * ATT_LDO + 8 * j) =
          make_float2(acc[j][2], acc[j][3]);
    }
  }
  __syncthreads();
  const int idx = 32 * kw + lane, row = idx >> 3, col = (idx & 7) * 8;
  if (m0 + row < S) {
    float y[8];
    load8(y, part + (size_t)(all + row) * ATT_LDO + col);
#pragma unroll
    for (int k = 1; k < ATT_KEY_WARPS; ++k) {
      float more[8];
      load8(more, part + (size_t)(all + 16 * k + row) * ATT_LDO + col);
#pragma unroll
      for (int i = 0; i < 8; ++i) y[i] += more[i];
    }
    store8(out + (size_t)(m0 + row) * hidden + blockIdx.x * HEAD_DIM + col,
           y);
  }
}

// ----------------------------- C interface ------------------------------

// Launches one instantiation; the first launch of each raises its dynamic
// shared-memory limit above the 48 KB default.
template <bool TRANS_B, int EPI, bool SPLIT>
static cudaError_t launch_gemm(dim3 grid, cudaStream_t stream, const bf16* a,
                               int lda, const bf16* b, int ldb,
                               const float* bias, const bf16* residual,
                               const float* layer_scale, void* out,
                               bf16* out2, float* partial, int m, int n,
                               int k) {
  auto kernel = gemm_kernel<TRANS_B, EPI, SPLIT>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM_BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  kernel<<<grid, GEMM_THREADS, GEMM_SMEM_BYTES, stream>>>(
      a, lda, b, ldb, bias, residual, layer_scale, out, out2, partial, m, n,
      k);
  return cudaGetLastError();
}

template <bool TRANS_B>
static cudaError_t launch_gemm_epilogue(int epilogue, dim3 grid,
                                        cudaStream_t stream, const bf16* a,
                                        int lda, const bf16* b, int ldb,
                                        const float* bias,
                                        const bf16* residual,
                                        const float* layer_scale, void* out,
                                        bf16* out2, int m, int n, int k) {
#define LAUNCH_GEMM(EPI)                                                  \
  return launch_gemm<TRANS_B, EPI, false>(grid, stream, a, lda, b, ldb,   \
                                          bias, residual, layer_scale,    \
                                          out, out2, nullptr, m, n, k)
  switch (epilogue) {
    case EPI_GELU: LAUNCH_GEMM(EPI_GELU);
    case EPI_RESIDUAL: LAUNCH_GEMM(EPI_RESIDUAL);
    case EPI_F32: LAUNCH_GEMM(EPI_F32);
    default: LAUNCH_GEMM(EPI_NONE);
  }
#undef LAUNCH_GEMM
}

template <bool TRANS_B, int EPI>
static cudaError_t launch_gemm_tma(cudaStream_t stream, const bf16* a,
                                   int lda, const bf16* b, int ldb,
                                   const float* bias, const bf16* residual,
                                   const float* layer_scale, void* out,
                                   bf16* out2, int m, int n, int k) {
  CUtensorMap map_a, map_b;
  // B^T is (n, k) in boxes of 256 rows; B is (k, n) in boxes of 64 rows
  if (!make_tensor_map(&map_a, a, m, k, lda, TMA_BM) ||
      !(TRANS_B ? make_tensor_map(&map_b, b, n, k, ldb, TMA_BN)
                : make_tensor_map(&map_b, b, k, n, ldb, 64)))
    return cudaErrorInvalidValue;
  auto kernel = gemm_tma_kernel<TRANS_B, EPI>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TMA_SMEM_BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(n / TMA_BN, (m + TMA_BM - 1) / TMA_BM);
  kernel<<<grid, 384, TMA_SMEM_BYTES, stream>>>(
      map_a, map_b, bias, residual, layer_scale, out, out2, m, n, k);
  return cudaGetLastError();
}

template <bool TRANS_B>
static cudaError_t launch_gemm_tma_epilogue(int epilogue, cudaStream_t stream,
                                            const bf16* a, int lda,
                                            const bf16* b, int ldb,
                                            const float* bias,
                                            const bf16* residual,
                                            const float* layer_scale,
                                            void* out, bf16* out2, int m,
                                            int n, int k) {
#define LAUNCH_TMA(EPI)                                                   \
  return launch_gemm_tma<TRANS_B, EPI>(stream, a, lda, b, ldb, bias,      \
                                       residual, layer_scale, out, out2, \
                                       m, n, k)
  switch (epilogue) {
    case EPI_GELU: LAUNCH_TMA(EPI_GELU);
    case EPI_RESIDUAL: LAUNCH_TMA(EPI_RESIDUAL);
    case EPI_F32: LAUNCH_TMA(EPI_F32);
    default: LAUNCH_TMA(EPI_NONE);
  }
#undef LAUNCH_TMA
}

static cudaError_t launch_splitk_finish(int epilogue, cudaStream_t stream,
                                        const float* partial, int splits,
                                        const float* bias,
                                        const bf16* residual,
                                        const float* layer_scale, void* out,
                                        bf16* out2, int m, int n) {
  const size_t groups = (size_t)m * n / 8;
  const unsigned blocks = (unsigned)((groups + 255) / 256);
#define LAUNCH_FINISH(EPI)                                     \
  splitk_finish_kernel<EPI><<<blocks, 256, 0, stream>>>(       \
      partial, splits, bias, residual, layer_scale, out, out2, m, n); \
  break
  switch (epilogue) {
    case EPI_GELU: LAUNCH_FINISH(EPI_GELU);
    case EPI_RESIDUAL: LAUNCH_FINISH(EPI_RESIDUAL);
    case EPI_F32: LAUNCH_FINISH(EPI_F32);
    default: LAUNCH_FINISH(EPI_NONE);
  }
#undef LAUNCH_FINISH
  return cudaGetLastError();
}

template <typename T>
static void launch_layer_norm(const void* x, const void* scale,
                              const void* bias, void* out, int rows, int d,
                              float eps, int chunks, int blocks, int warps,
                              cudaStream_t stream) {
  const T* px = (const T*)x;
  const float *ps = (const float*)scale, *pb = (const float*)bias;
  if (chunks == 0)
    layer_norm_kernel<T><<<rows, LN_THREADS, 0, stream>>>(px, ps, pb, (T*)out,
                                                          d, eps);
  else if (chunks <= 3)
    layer_norm_rows_kernel<T, 3><<<blocks, 32 * warps, 0, stream>>>(
        px, ps, pb, (T*)out, rows, d, eps);
  else
    layer_norm_rows_kernel<T, 4><<<blocks, 32 * warps, 0, stream>>>(
        px, ps, pb, (T*)out, rows, d, eps);
}

extern "C" {

// x and out are fp32 with `is_f32`, else bf16. chunks 0: one block per row
// (any d). Else the warp-per-row kernel: chunks = the 8-value chunks a lane
// holds (d % 8 == 0, d <= 256 * chunks <= 1024; x, scale, bias, out 16-byte
// aligned), `blocks` blocks of `warps` (at most 8) warps.
int dino_layer_norm(const void* x, const void* scale, const void* bias,
                    void* out, int rows, int d, float eps, int is_f32,
                    int chunks, int blocks, int warps, void* stream) {
  if (chunks != 0 && (chunks < 0 || chunks > 4 || d % 8 != 0 ||
                      d > 256 * chunks || warps < 1 || warps > 8 ||
                      blocks < 1))
    return (int)cudaErrorInvalidValue;
  if (is_f32)
    launch_layer_norm<float>(x, scale, bias, out, rows, d, eps, chunks,
                             blocks, warps, (cudaStream_t)stream);
  else
    launch_layer_norm<bf16>(x, scale, bias, out, rows, d, eps, chunks, blocks,
                            warps, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// block_n 256 selects the TMA kernel's 128 x 256 tile (n % 256 == 0), else
// the tile is 64 x 64 (n % 64 == 0); with split_k > 1 (64 x 64 only;
// split_k divides the number of 64-deep k-tiles) `partial` is fp32 scratch
// of split_k * m * n.
int dino_gemm(const void* a, int lda, const void* b, int ldb, int trans_b,
              const void* bias, const void* residual, const void* layer_scale,
              void* out, void* out2, int m, int n, int k, int epilogue,
              int block_n, int split_k, void* partial, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const bf16 *pa = (const bf16*)a, *pb = (const bf16*)b;
  const float *pbias = (const float*)bias, *pls = (const float*)layer_scale;
  const bf16* pres = (const bf16*)residual;
  if (block_n == TMA_BN)
    return (int)(trans_b ? launch_gemm_tma_epilogue<true>(
                               epilogue, st, pa, lda, pb, ldb, pbias, pres,
                               pls, out, (bf16*)out2, m, n, k)
                         : launch_gemm_tma_epilogue<false>(
                               epilogue, st, pa, lda, pb, ldb, pbias, pres,
                               pls, out, (bf16*)out2, m, n, k));
  const dim3 grid(n / BN, (m + BM - 1) / BM, split_k);
  if (split_k == 1)
    return (int)(trans_b ? launch_gemm_epilogue<true>(
                               epilogue, grid, st, pa, lda, pb, ldb, pbias,
                               pres, pls, out, (bf16*)out2, m, n, k)
                         : launch_gemm_epilogue<false>(
                               epilogue, grid, st, pa, lda, pb, ldb, pbias,
                               pres, pls, out, (bf16*)out2, m, n, k));
  const cudaError_t err =
      trans_b ? launch_gemm<true, EPI_F32, true>(
                    grid, st, pa, lda, pb, ldb, nullptr, nullptr, nullptr,
                    nullptr, nullptr, (float*)partial, m, n, k)
              : launch_gemm<false, EPI_F32, true>(
                    grid, st, pa, lda, pb, ldb, nullptr, nullptr, nullptr,
                    nullptr, nullptr, (float*)partial, m, n, k);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_splitk_finish(epilogue, st, (const float*)partial,
                                   split_k, pbias, pres, pls, out,
                                   (bf16*)out2, m, n);
}

// The longest sequence the attention takes: a row's scores in the registers
// of its key warps.
int dino_attention_max_seq() { return ATT_MAX_SEQ; }

// grid (hidden / 64, ceil(seq / (16 * warps))): `warps` (1 to 4) row warps
// of 16 query rows a block, each of ATT_KEY_WARPS key warps.
int dino_attention(const void* qkv, void* out, int seq, int hidden,
                   int warps, void* stream) {
  if (warps < 1 || warps > 4 || seq < 1 || seq > ATT_MAX_SEQ)
    return (int)cudaErrorInvalidValue;
  // the first launch raises the dynamic shared-memory limit above the 48 KB
  // default
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        att_smem_bytes(ATT_MAX_SEQ, 4));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid(hidden / HEAD_DIM, (seq + 16 * warps - 1) / (16 * warps));
  attention_kernel<<<grid, 32 * warps * ATT_KEY_WARPS,
                     att_smem_bytes(seq, warps), (cudaStream_t)stream>>>(
      (const bf16*)qkv, (bf16*)out, seq, hidden);
  return (int)cudaGetLastError();
}

}  // extern "C"
