// Backward of the DINOv2 training layer and of the training LayerNorm for
// Hopper (sm_90a): the device code that the forward kernels of
// dino_layer.cu and fused_attention.cu do not already hold.
//
// Replaces the body of the Pallas TPU kernels
// hypervla_tpu/ops/dino_layer_train.py::_bwd_kernel (one whole layer's
// backward held in VMEM) and hypervla_tpu/ops/layer_norm.py::
// _ln_train_bwd_kernel (the LayerNorm backward of layer_norm_pallas). On
// Hopper the layer's backward is composed of launches by
// hypervla_tpu_torch/ops/dino_layer_train.py, at the TPU kernel's rounding
// points; what this file adds to the A.B^T products of dino_layer.cu's GEMM
// and the attention backward of fused_attention.cu:
//
//   layer_gemm_tn      out = bf16(A^T B), the sum over all B*S rows kept in
//                      fp32 and rounded once: the weight gradients
//   layer_norm_bwd     the LayerNorm input gradient of one row, statistics
//                      recomputed from the input with the forward's fast
//                      variance, plus per-block column sums of g*xhat and g
//                      (dscale, dbias). One kernel for the layer (fp32
//                      cotangent, dx rounded to bf16 and added in bf16 to
//                      the residual gradient) and for the training
//                      LayerNorm (cotangent and dx in x's type)
//   layer_scale_grad   dy = g * bf16(ls) with the column sums of
//                      f32(g)*f32(y) (d layer scale) and f32(dy) (d bias)
//   layer_gelu_bwd     h = bf16(gelu(hc)) recomputed, dhc = bf16(gelu'(hc))
//                      * dh in bf16, the column sums of f32(dhc) (d fc1 bias)
//   layer_colsum       column sums of a bf16 matrix (dq, dk, dv -> biases)
//   layer_finish_sums  sums the per-block partials in block order
//
// No atomics anywhere: a column sum is per-block partials in fp32, then one
// finishing launch that adds them in a fixed order; a weight gradient tile
// is owned by one block that walks all rows or, where the tiles are too few
// for the card, by `split` blocks that each walk one contiguous range of the
// rows and leave an fp32 partial tile, added in split order by a finishing
// launch and rounded once. Results repeat bit for bit.
//
// What bounds the layer backward on this card is the GEMM work (~466 GFLOP
// at B=64 against ~1 GB moved), half of it the four weight gradients (233
// GFLOP, K1 x N outputs of 768 x 768 up to 3072 x 768 contracted over
// 16448 rows). They run on `wgmma` with both operands MN-major, fed by TMA
// (see the note at the kernel).
//
// Plain C interface (loaded with ctypes). Every entry point launches on the
// given stream and returns cudaGetLastError().

#include "wgmma_tma.cuh"

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 tobf(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ float rbf(float v) { return bf(tobf(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------ A^T B GEMM ------------------------------
// out[K1, N] = bf16(A[M, K1]^T @ B[M, N]): A and B row-major bf16 with row
// strides lda, ldb, contracted over their M rows, the sum kept in fp32 and
// rounded to bf16 once.
//
// What bounds it: operations (2 M K1 N; each operand value is needed K1 or N
// times), so the product runs on `wgmma` at m64nNk16. The contracted
// dimension M is the strided one of both A and B, so both operands are
// MN-major: a stage of the shared-memory ring holds 64 rows x 64 columns
// boxes of A and of B exactly as they lie in memory (128-byte rows, 128-byte
// swizzled, written by TMA), and the descriptors' transpose bits read them;
// no transposed copy of A exists before or after. One thread of a producer
// warpgroup keeps the TMA loads of the next row tiles in flight; WGS consumer
// warpgroups multiply the tiles that have arrived, each 64 rows of the 64 WGS
// x BN_T output tile, and release a stage to its `empty` barrier once the
// `wgmma` that read it has completed. Rows past M are zero-filled by TMA's
// clipping.
//
// The tiles are few (18 to 72 of 128 x 256 at the flagship's shapes against
// 132 multiprocessors), so the rows are split: block (tile, s) of grid
// (tiles, split) walks row tiles [s R / split, (s + 1) R / split) of the R =
// ceil(M / 64). With split 1 it rounds and writes bf16; else it writes its
// fp32 sums to partial[s][K1][N] and `gemm_tn_finish_kernel` adds the parts
// in split order and rounds once. Blocks of one split are neighbours in the
// grid, so the blocks resident at one time read the same rows of A and B
// through the L2. The split is chosen by the wrapper
// (ops/dino_layer_train.py::gemm_tn_config) from the shape alone.
// K1 % (64 WGS) == 0 and N % BN_T == 0 are checked by the wrapper.

constexpr int TN_STAGES = 4;

template <int WGS, int BN_T>
struct TnTile {
  static constexpr int A_BYTES = WGS * 64 * 128;
  static constexpr int B_BYTES = BN_T * 128;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // ring, 1 KB to align it, 2 x TN_STAGES 8-byte barriers
  static constexpr int SMEM_BYTES = TN_STAGES * STAGE_BYTES + 1024 + 64;
  static constexpr int THREADS = 128 * (WGS + 1);
};

// grid (K1 / (64 WGS) * N / BN_T, split); 128 (WGS + 1) threads.
template <int WGS, int BN_T>
__global__ void __launch_bounds__(128 * (WGS + 1), 1) gemm_tn_kernel(
    const __grid_constant__ CUtensorMap map_a,
    const __grid_constant__ CUtensorMap map_b, bf16* __restrict__ out,
    float* __restrict__ partial, int M, int K1, int N) {
  using T = TnTile<WGS, BN_T>;
  extern __shared__ unsigned char gemm_smem[];
  const uint32_t ring = (smem_u32(gemm_smem) + 1023u) & ~1023u;
  const uint32_t full = ring + TN_STAGES * T::STAGE_BYTES;
  const uint32_t empty = full + 8 * TN_STAGES;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int tiles_n = N / BN_T;
  const int i0 = (blockIdx.x / tiles_n) * (64 * WGS);
  const int n0 = (blockIdx.x % tiles_n) * BN_T;
  const int row_tiles = (M + 63) / 64;
  const int split = gridDim.y, s = blockIdx.y;
  const int first = (int)((long long)s * row_tiles / split);
  const int count = (int)((long long)(s + 1) * row_tiles / split) - first;

  if (tid == 0) {
    for (int st = 0; st < TN_STAGES; ++st) {
      mbar_init(full + 8 * st, 1);         // the producer's expect_tx
      mbar_init(empty + 8 * st, 4 * WGS);  // one lane of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == WGS) {
    // the large tile's consumers hold 128 accumulators a thread: the
    // producer's registers move to them
    if constexpr (WGS == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 128 * WGS) {
      for (int i = 0; i < count; ++i) {
        const int st = i % TN_STAGES;
        // the stage's previous tile (i - TN_STAGES) has been multiplied
        if (i >= TN_STAGES)
          mbar_wait(empty + 8 * st, (i / TN_STAGES - 1) & 1);
        const uint32_t sa = ring + st * T::STAGE_BYTES;
        const uint32_t sb = sa + T::A_BYTES;
        const int m0 = (first + i) * 64;
        mbar_expect_tx(full + 8 * st, T::STAGE_BYTES);
#pragma unroll
        for (int j = 0; j < WGS; ++j)
          tma_load_2d(sa + j * 8192, &map_a, full + 8 * st, i0 + 64 * j, m0);
#pragma unroll
        for (int j = 0; j < BN_T / 64; ++j)
          tma_load_2d(sb + j * 8192, &map_b, full + 8 * st, n0 + 64 * j, m0);
      }
    }
    return;
  }

  if constexpr (WGS == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  float acc[BN_T / 2];
#pragma unroll
  for (int i = 0; i < BN_T / 2; ++i) acc[i] = 0.f;
  const int lane = tid & 31;
  for (int i = 0; i < count; ++i) {
    const int st = i % TN_STAGES;
    mbar_wait(full + 8 * st, (i / TN_STAGES) & 1);
    const uint32_t sa = ring + st * T::STAGE_BYTES;
    // MN-major tiles: 8 KB from one 64-column box to the next (A has one
    // box a warpgroup), 1 KB from one group of 8 rows to the next
    const uint64_t da = wgmma_desc(sa + wg * 8192, 8192, 1024);
    const uint64_t db = wgmma_desc(sa + T::A_BYTES, 8192, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      // a k-step is 16 rows of 128 bytes; the address is in 16-byte units
      wgmma_k16<1, 1>(acc, da + kk * 128, db + kk * 128, (i | kk) != 0);
    wgmma_commit();
    // row tile i - 1's wgmma has completed: its stage may be refilled
    wgmma_wait<1>();
    if (i > 0 && lane == 0) mbar_arrive(empty + 8 * ((i - 1) % TN_STAGES));
  }
  wgmma_wait<0>();

  // Straight from the accumulator registers: thread (warp w, lane 4g + t)
  // holds rows 16w + g and 16w + g + 8 and, for each 8-column group j,
  // columns 8j + 2t and 8j + 2t + 1; a quad writes 32 (fp32) or 16 (bf16)
  // neighbouring bytes of a row. The output is 1/257 of the operand reads.
  const int row = i0 + wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const size_t o = (size_t)row * N + n0 + 2 * (lane & 3);
  if (split == 1) {
#pragma unroll
    for (int j = 0; j < BN_T / 8; ++j) {
      *reinterpret_cast<uint32_t*>(out + o + 8 * j) =
          pack2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(out + o + (size_t)8 * N + 8 * j) =
          pack2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  } else {
    float* part = partial + (size_t)s * K1 * N;
#pragma unroll
    for (int j = 0; j < BN_T / 8; ++j) {
      *reinterpret_cast<float2*>(part + o + 8 * j) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(part + o + (size_t)8 * N + 8 * j) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// One thread per eight outputs: adds the splits' partial sums in split
// order and rounds once.
__global__ void __launch_bounds__(256) gemm_tn_finish_kernel(
    const float* __restrict__ partial, int split, bf16* __restrict__ out,
    size_t total) {
  const size_t first = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (first >= total) return;
  float sums[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < split; ++s) {
    float part[8];
    load8(part, partial + s * total + first);
#pragma unroll
    for (int i = 0; i < 8; ++i) sums[i] += part[i];
  }
  store8(out + first, sums);
}

// -------------------------- LayerNorm backward --------------------------
// One block walks rows [blockIdx.x * rpb, +rpb); thread t owns columns
// t, t + 256, ... (at most LN_MAXC of them: d <= 2048). Per row:
//   mu, rs from the fast variance max(E[x^2] - mu^2, 0) of the forward;
//   xhat = (x - mu) * rs; dxhat = g * scale;
//   dx = rs * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))   (fp32)
// With ADD (the layer), dx is rounded to bf16 and added in bf16 to the
// incoming residual gradient; else it is rounded once to x's type. The
// block's column sums of g * xhat and g go to part[block][0/1][d].

constexpr int LN_THREADS = 256;
constexpr int LN_MAXC = 8;

__device__ __forceinline__ float ld(const bf16* p) { return bf(*p); }
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ void st(bf16* p, float v) { *p = tobf(v); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }

// Sums a and b over the block; every thread adds the warps' sums in the
// same order, so all of them hold the same bits.
__device__ __forceinline__ void block_sum2(float& a, float& b,
                                           float (*red)[LN_THREADS / 32]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  a = warp_sum(a);
  b = warp_sum(b);
  __syncthreads();  // the previous sums have been read
  if (lane == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();
  a = 0.f;
  b = 0.f;
#pragma unroll
  for (int w = 0; w < LN_THREADS / 32; ++w) {
    a += red[0][w];
    b += red[1][w];
  }
}

template <typename TX, typename TG, bool ADD>
__global__ void __launch_bounds__(LN_THREADS) layer_norm_bwd_kernel(
    const TX* __restrict__ x, const TG* __restrict__ g,
    const float* __restrict__ scale, const TX* __restrict__ residual,
    TX* __restrict__ dx, float* __restrict__ part, int rows, int d, int rpb,
    float eps) {
  __shared__ float red[2][LN_THREADS / 32];
  const int tid = threadIdx.x;
  float sc[LN_MAXC], sum_gx[LN_MAXC], sum_g[LN_MAXC];
#pragma unroll
  for (int j = 0; j < LN_MAXC; ++j) {
    const int c = tid + j * LN_THREADS;
    sc[j] = c < d ? scale[c] : 0.f;
    sum_gx[j] = 0.f;
    sum_g[j] = 0.f;
  }
  const int row0 = blockIdx.x * rpb;
  const int row1 = min(rows, row0 + rpb);
  for (int r = row0; r < row1; ++r) {
    const size_t base = (size_t)r * d;
    float xv[LN_MAXC], gv[LN_MAXC];
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < LN_MAXC; ++j) {
      const int c = tid + j * LN_THREADS;
      xv[j] = c < d ? ld(x + base + c) : 0.f;
      gv[j] = c < d ? ld(g + base + c) : 0.f;
      s += xv[j];
      s2 += xv[j] * xv[j];
    }
    block_sum2(s, s2, red);
    const float mu = s / (float)d;
    const float var = fmaxf(s2 / (float)d - mu * mu, 0.f);
    const float rs = rsqrtf(var + eps);
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int j = 0; j < LN_MAXC; ++j) {
      const int c = tid + j * LN_THREADS;
      if (c < d) {
        const float xhat = (xv[j] - mu) * rs;
        const float dxhat = gv[j] * sc[j];
        sum_gx[j] += gv[j] * xhat;
        sum_g[j] += gv[j];
        a += dxhat;
        b += dxhat * xhat;
        xv[j] = xhat;
        gv[j] = dxhat;
      }
    }
    block_sum2(a, b, red);
    const float m1 = a / (float)d, m2 = b / (float)d;
#pragma unroll
    for (int j = 0; j < LN_MAXC; ++j) {
      const int c = tid + j * LN_THREADS;
      if (c < d) {
        float v = rs * (gv[j] - m1 - xv[j] * m2);
        if (ADD) v = ld(residual + base + c) + rbf(v);
        st(dx + base + c, v);
      }
    }
  }
  float* p = part + (size_t)blockIdx.x * 2 * d;
#pragma unroll
  for (int j = 0; j < LN_MAXC; ++j) {
    const int c = tid + j * LN_THREADS;
    if (c < d) {
      p[c] = sum_gx[j];
      p[d + c] = sum_g[j];
    }
  }
}

// ------------------- elementwise passes with column sums -------------------
// grid (ceil(cols / 256), ceil(rows / rpb)): thread t of block (bx, by) owns
// column bx * 256 + t over rows [by * rpb, +rpb), so a warp reads 32
// neighbouring columns of one row. Partials go to part[by][sum][cols].

constexpr int CP_THREADS = 256;

// dy = bf16(g * bf16(ls)); sums: f32(g) * f32(y), f32(dy)
__global__ void __launch_bounds__(CP_THREADS) scale_grad_kernel(
    const bf16* __restrict__ g, const bf16* __restrict__ y,
    const float* __restrict__ ls, bf16* __restrict__ dy,
    float* __restrict__ part, int rows, int cols, int rpb) {
  const int c = blockIdx.x * CP_THREADS + threadIdx.x;
  if (c >= cols) return;
  const float l = rbf(ls[c]);
  const int row1 = min(rows, (int)(blockIdx.y + 1) * rpb);
  float s_ls = 0.f, s_b = 0.f;
  for (int r = blockIdx.y * rpb; r < row1; ++r) {
    const size_t o = (size_t)r * cols + c;
    const float gv = bf(g[o]);
    const float d = rbf(gv * l);
    s_ls += gv * bf(y[o]);
    s_b += d;
    dy[o] = tobf(d);
  }
  float* p = part + (size_t)blockIdx.y * 2 * cols;
  p[c] = s_ls;
  p[cols + c] = s_b;
}

// h = bf16(gelu(hc)), dhc = bf16(bf16(gelu'(hc)) * dh); sum: f32(dhc).
// gelu(x) = x * cdf, gelu'(x) = cdf + x * pdf, cdf = 0.5 (1 + erf(x / sqrt 2))
__global__ void __launch_bounds__(CP_THREADS) gelu_bwd_kernel(
    const bf16* __restrict__ hc, const bf16* __restrict__ dh,
    bf16* __restrict__ h, bf16* __restrict__ dhc, float* __restrict__ part,
    int rows, int cols, int rpb) {
  const int c = blockIdx.x * CP_THREADS + threadIdx.x;
  if (c >= cols) return;
  const int row1 = min(rows, (int)(blockIdx.y + 1) * rpb);
  float s = 0.f;
  for (int r = blockIdx.y * rpb; r < row1; ++r) {
    const size_t o = (size_t)r * cols + c;
    const float x = bf(hc[o]);
    const float cdf = 0.5f * (1.f + erff(x * 0.70710678118654752f));
    const float pdf = expf(-0.5f * x * x) * 0.3989422804014327f;
    const float d = rbf(rbf(cdf + x * pdf) * bf(dh[o]));
    h[o] = tobf(x * cdf);
    dhc[o] = tobf(d);
    s += d;
  }
  part[(size_t)blockIdx.y * cols + c] = s;
}

__global__ void __launch_bounds__(CP_THREADS) colsum_kernel(
    const bf16* __restrict__ a, float* __restrict__ part, int rows, int cols,
    int rpb) {
  const int c = blockIdx.x * CP_THREADS + threadIdx.x;
  if (c >= cols) return;
  const int row1 = min(rows, (int)(blockIdx.y + 1) * rpb);
  float s = 0.f;
  for (int r = blockIdx.y * rpb; r < row1; ++r)
    s += bf(a[(size_t)r * cols + c]);
  part[(size_t)blockIdx.y * cols + c] = s;
}

// out[j] = sum over p of part[p][j], p in order
__global__ void __launch_bounds__(CP_THREADS) finish_sums_kernel(
    const float* __restrict__ part, float* __restrict__ out, int parts,
    int width) {
  const int j = blockIdx.x * CP_THREADS + threadIdx.x;
  if (j >= width) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += part[(size_t)p * width + j];
  out[j] = s;
}

// ----------------------------- C interface ------------------------------

static dim3 column_grid(int rows, int cols, int rpb) {
  return dim3((cols + CP_THREADS - 1) / CP_THREADS, (rows + rpb - 1) / rpb);
}

// Launches one tile's instantiation; its first launch raises the dynamic
// shared-memory limit above the 48 KB default.
template <int WGS, int BN_T>
static cudaError_t launch_gemm_tn(cudaStream_t stream, const bf16* a, int lda,
                                  const bf16* b, int ldb, bf16* out,
                                  float* partial, int m, int k1, int n,
                                  int split) {
  using T = TnTile<WGS, BN_T>;
  CUtensorMap map_a, map_b;
  if (!make_tensor_map(&map_a, a, m, k1, lda, 64) ||
      !make_tensor_map(&map_b, b, m, n, ldb, 64))
    return cudaErrorInvalidValue;
  auto kernel = gemm_tn_kernel<WGS, BN_T>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((k1 / (64 * WGS)) * (n / BN_T), split);
  kernel<<<grid, T::THREADS, T::SMEM_BYTES, stream>>>(map_a, map_b, out,
                                                      partial, m, k1, n);
  return cudaGetLastError();
}

extern "C" {

// block_n 256 selects the 128 x 256 tile (k1 % 128 == 0, n % 256 == 0),
// else the tile is 64 x 64 (k1 % 64 == 0, n % 64 == 0). With split > 1
// `partial` is fp32 scratch of split * k1 * n.
int layer_gemm_tn(const void* a, int lda, const void* b, int ldb, void* out,
                  int m, int k1, int n, int block_n, int split, void* partial,
                  void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      block_n == 256
          ? launch_gemm_tn<2, 256>(st, (const bf16*)a, lda, (const bf16*)b,
                                   ldb, (bf16*)out, (float*)partial, m, k1, n,
                                   split)
          : launch_gemm_tn<1, 64>(st, (const bf16*)a, lda, (const bf16*)b,
                                  ldb, (bf16*)out, (float*)partial, m, k1, n,
                                  split);
  if (err != cudaSuccess || split == 1) return (int)err;
  const size_t total = (size_t)k1 * n;
  gemm_tn_finish_kernel<<<(unsigned)((total / 8 + 255) / 256), 256, 0, st>>>(
      (const float*)partial, split, (bf16*)out, total);
  return (int)cudaGetLastError();
}

// The widest row layer_norm_bwd takes.
int layer_norm_bwd_max_width() { return LN_THREADS * LN_MAXC; }

// mode 0: x bf16, g fp32, dx = residual + bf16(dx) in bf16 (the layer);
// mode 1: x, g, dx bf16; mode 2: x, g, dx fp32 (the training LayerNorm).
// part is ceil(rows / rpb) x 2 x d fp32.
int layer_norm_bwd(const void* x, const void* g, const void* scale,
                   const void* residual, void* dx, void* part, int rows,
                   int d, int rpb, float eps, int mode, void* stream) {
  const int grid = (rows + rpb - 1) / rpb;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0)
    layer_norm_bwd_kernel<bf16, float, true><<<grid, LN_THREADS, 0, s>>>(
        (const bf16*)x, (const float*)g, (const float*)scale,
        (const bf16*)residual, (bf16*)dx, (float*)part, rows, d, rpb, eps);
  else if (mode == 1)
    layer_norm_bwd_kernel<bf16, bf16, false><<<grid, LN_THREADS, 0, s>>>(
        (const bf16*)x, (const bf16*)g, (const float*)scale, nullptr,
        (bf16*)dx, (float*)part, rows, d, rpb, eps);
  else
    layer_norm_bwd_kernel<float, float, false><<<grid, LN_THREADS, 0, s>>>(
        (const float*)x, (const float*)g, (const float*)scale, nullptr,
        (float*)dx, (float*)part, rows, d, rpb, eps);
  return (int)cudaGetLastError();
}

int layer_scale_grad(const void* g, const void* y, const void* ls, void* dy,
                     void* part, int rows, int cols, int rpb, void* stream) {
  scale_grad_kernel<<<column_grid(rows, cols, rpb), CP_THREADS, 0,
                      (cudaStream_t)stream>>>(
      (const bf16*)g, (const bf16*)y, (const float*)ls, (bf16*)dy,
      (float*)part, rows, cols, rpb);
  return (int)cudaGetLastError();
}

int layer_gelu_bwd(const void* hc, const void* dh, void* h, void* dhc,
                   void* part, int rows, int cols, int rpb, void* stream) {
  gelu_bwd_kernel<<<column_grid(rows, cols, rpb), CP_THREADS, 0,
                    (cudaStream_t)stream>>>(
      (const bf16*)hc, (const bf16*)dh, (bf16*)h, (bf16*)dhc, (float*)part,
      rows, cols, rpb);
  return (int)cudaGetLastError();
}

int layer_colsum(const void* a, void* part, int rows, int cols, int rpb,
                 void* stream) {
  colsum_kernel<<<column_grid(rows, cols, rpb), CP_THREADS, 0,
                  (cudaStream_t)stream>>>((const bf16*)a, (float*)part, rows,
                                          cols, rpb);
  return (int)cudaGetLastError();
}

int layer_finish_sums(const void* part, void* out, int parts, int width,
                      void* stream) {
  finish_sums_kernel<<<(width + CP_THREADS - 1) / CP_THREADS, CP_THREADS, 0,
                       (cudaStream_t)stream>>>((const float*)part,
                                               (float*)out, parts, width);
  return (int)cudaGetLastError();
}

}  // extern "C"
