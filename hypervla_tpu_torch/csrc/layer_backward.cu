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
//   layer_norm_bwd     the LayerNorm input gradient of one row (a warp per
//                      row where the width allows), statistics
//                      recomputed from the input with the forward's fast
//                      variance, plus per-block column sums of g*xhat and g
//                      (dscale, dbias). One kernel for the layer (fp32
//                      cotangent, dx rounded to bf16 and added in bf16 to
//                      the residual gradient) and for the training
//                      LayerNorm (cotangent and dx in x's type)
//   layer_scale_grad   dy = g * bf16(ls) with the column sums of
//                      f32(g)*f32(y) (d layer scale) and f32(dy) (d bias),
//                      on the column sum's 16-byte rows
//   layer_gelu_bwd     h = bf16(gelu(hc)) recomputed, dhc = bf16(gelu'(hc))
//                      * dh in bf16, the column sums of f32(dhc) (d fc1
//                      bias), on the column sum's 16-byte rows
//   layer_colsum       column sums of a bf16 matrix (dq, dk, dv -> biases)
//   layer_finish_sums  sums the per-block partials of every column sum:
//                      eight warps a column, then their sums in warp order
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
#include "gelu_fit.cuh"
#include "row_vec.cuh"

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 tobf(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ float rbf(float v) { return bf(tobf(v)); }

using row::warp_sum;

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
// Per row:
//   mu, rs from the fast variance max(E[x^2] - mu^2, 0) of the forward;
//   xhat = (x - mu) * rs; dxhat = g * scale;
//   dx = rs * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))   (fp32)
// With ADD (the layer), dx is rounded to bf16 and added in bf16 to the
// incoming residual gradient; else it is rounded once to x's type. The
// block's column sums of g * xhat and g go to part[block][0/1][d].
//
// What bounds it: bytes (x, g and the residual read once, dx written once;
// 14 operations a value). `layer_norm_bwd_rows_kernel` is the kernel of every
// width that is a multiple of 8 up to 256 CH (the wrapper chooses,
// ops/layer_norm.py): a warp owns a row and holds x and g of it in registers
// as CH chunks of eight values a lane (row_vec.cuh): 16-byte loads, the four
// sums of a row as two pairs of warp shuffles, no barrier in the row loop.
// A warp walks rows gw, gw + (warps of the grid), ... and keeps the column
// sums of its rows in registers (16 CH a lane), which with x, g and scale
// makes ~200 registers a thread: blocks of two warps, four a multiprocessor,
// one wave (a second row's loads held in registers ahead of time measured
// no faster, and a cap of 168 registers for three larger blocks spilled). At
// the end the warps of a block add theirs in warp order through shared
// memory and the block writes one partial. Which rows a warp takes depends
// on the shape and the grid alone, so two runs add in the same order.
// `layer_norm_bwd_kernel` below stays for the other widths: one block walks
// rows [blockIdx.x * rpb, +rpb); thread t owns columns t, t + 256, ... (at
// most LN_MAXC of them: d <= 2048), two block sums a row.

// grid: any number of blocks of 32 * warps threads (warps <= 8).
template <typename TX, typename TG, bool ADD, int CH>
__global__ void __launch_bounds__(256) layer_norm_bwd_rows_kernel(
    const TX* __restrict__ x, const TG* __restrict__ g,
    const float* __restrict__ scale, const TX* __restrict__ residual,
    TX* __restrict__ dx, float* __restrict__ part, int rows, int d,
    float eps) {
  __shared__ float red[2 * 256 * CH];  // the block's sums: g * xhat, then g
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int stride = gridDim.x * warps;
  const int chunks = d >> 3;
  float sc[CH][8], sum_gx[CH][8], sum_g[CH][8];
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    if (lane + 32 * i < chunks) row::load8(sc[i], scale + 8 * (lane + 32 * i));
#pragma unroll
    for (int k = 0; k < 8; ++k) sum_gx[i][k] = sum_g[i][k] = 0.f;
  }
  for (int r = blockIdx.x * warps + warp; r < rows; r += stride) {
    // every load of the row is requested before any of it is used
    row::Raw<TX> xc[CH], res[CH];
    row::Raw<TG> gc[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      if (lane + 32 * i < chunks) {
        const size_t o = (size_t)r * d + 8 * (lane + 32 * i);
        row::load_raw(xc[i], x + o);
        row::load_raw(gc[i], g + o);
        if (ADD) row::load_raw(res[i], residual + o);
      }
    }
    float xv[CH][8], gv[CH][8];
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      if (lane + 32 * i < chunks) {
        row::widen(xv[i], xc[i]);
        row::widen(gv[i], gc[i]);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          s += xv[i][k];
          s2 += xv[i][k] * xv[i][k];
        }
      }
    }
    row::warp_sum2(s, s2);
    const float mu = s / (float)d;
    const float var = fmaxf(s2 / (float)d - mu * mu, 0.f);
    const float rs = rsqrtf(var + eps);
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      if (lane + 32 * i < chunks) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float xhat = (xv[i][k] - mu) * rs;
          const float dxhat = gv[i][k] * sc[i][k];
          sum_gx[i][k] += gv[i][k] * xhat;
          sum_g[i][k] += gv[i][k];
          a += dxhat;
          b += dxhat * xhat;
          xv[i][k] = xhat;
          gv[i][k] = dxhat;
        }
      }
    }
    row::warp_sum2(a, b);
    const float m1 = a / (float)d, m2 = b / (float)d;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      if (lane + 32 * i < chunks) {
        float y[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          y[k] = rs * (gv[i][k] - m1 - xv[i][k] * m2);
        if (ADD) {
          float rv[8];
          row::widen(rv, res[i]);
#pragma unroll
          for (int k = 0; k < 8; ++k) y[k] = rv[k] + rbf(y[k]);
        }
        row::store8(dx + (size_t)r * d + 8 * (lane + 32 * i), y);
      }
    }
  }
  // the warps' sums, added in warp order
  for (int w = 0; w < warps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        if (lane + 32 * i < chunks) {
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int c = 8 * (lane + 32 * i) + k;
            red[c] = (w ? red[c] : 0.f) + sum_gx[i][k];
            red[d + c] = (w ? red[d + c] : 0.f) + sum_g[i][k];
          }
        }
      }
    }
    __syncthreads();
  }
  float* p = part + (size_t)blockIdx.x * 2 * d;
  for (int c = threadIdx.x; c < 2 * d; c += blockDim.x) p[c] = red[c];
}

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

// ------------------ column sums along 16-byte rows ------------------
// colsum_kernel: part[p][c] = the fp32 sum of a[r][c] over the rows of part
// p, [p rows / parts, (p + 1) rows / parts): the TPU kernel's dbq / dbk / dbv
// (f32 sums of dq, dk, dv over the rows inside `_bwd_kernel`) over the port's
// fused dqkv.
//
// What bounds it: bytes (each value read once, one fp32 add). A thread a
// column with 2-byte loads moves 64 bytes a warp-wide load; here grid
// (strips, parts): block (s, p) owns columns [256 s, +256) of part p's rows
// and lane l of each of its warps the 8 neighbouring columns 256 s + 8 l,
// one 16-byte load a row (a warp reads 512 contiguous bytes of it). Warp w
// of the block's `warps` takes rows r0 + w, r0 + w + warps, ... of the part
// in that order, COLSUM_ROWS of them loaded before any is added, into 8 fp32
// running sums a lane; the block adds its warps' sums in warp order through
// shared memory and writes one partial (block_column_partial), and
// finish_sums_split_kernel adds the partials. The grid, and with it the
// order of every sum, comes from the shape alone (ops/dino_layer_train.py::
// colsum_config). cols % 8 == 0 and a 16-byte aligned are checked by the
// wrapper.

constexpr int COLSUM_MAX_WARPS = 8;
constexpr int COLSUM_ROWS = 4;

// The block's warps' sums of its 256 columns added in warp order, written
// to `row` (a partial's row of cols). Two calls in one block need a barrier
// between them: the second reuses the first's shared memory.
__device__ __forceinline__ void block_column_partial(
    const float (&sum)[8], float* __restrict__ row, int cols) {
  __shared__ float4 red[COLSUM_MAX_WARPS][64];  // a warp's 256 column sums
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  red[warp][2 * lane] = make_float4(sum[0], sum[1], sum[2], sum[3]);
  red[warp][2 * lane + 1] = make_float4(sum[4], sum[5], sum[6], sum[7]);
  __syncthreads();
  const float* sums = reinterpret_cast<const float*>(red);
  for (int c = threadIdx.x; c < 256; c += blockDim.x) {
    const int col = blockIdx.x * 256 + c;
    if (col >= cols) break;
    float s = sums[c];
    for (int w = 1; w < warps; ++w) s += sums[w * 256 + c];
    row[col] = s;
  }
}

__global__ void __launch_bounds__(32 * COLSUM_MAX_WARPS) colsum_kernel(
    const bf16* __restrict__ a, float* __restrict__ part, int rows,
    int cols) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int p = blockIdx.y, parts = gridDim.y;
  const int r0 = (int)((long long)p * rows / parts);
  const int r1 = (int)((long long)(p + 1) * rows / parts);
  const int c0 = blockIdx.x * 256 + 8 * lane;
  float sum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (c0 < cols) {
    for (int r = r0 + warp; r < r1; r += COLSUM_ROWS * warps) {
      row::Raw<bf16> raw[COLSUM_ROWS];
#pragma unroll
      for (int k = 0; k < COLSUM_ROWS; ++k)
        if (r + k * warps < r1)
          raw[k].v = __ldg(reinterpret_cast<const uint4*>(
              a + (size_t)(r + k * warps) * cols + c0));
#pragma unroll
      for (int k = 0; k < COLSUM_ROWS; ++k) {
        if (r + k * warps < r1) {
          float v[8];
          row::widen(v, raw[k]);
#pragma unroll
          for (int j = 0; j < 8; ++j) sum[j] += v[j];
        }
      }
    }
  }
  block_column_partial(sum, part + (size_t)p * cols, cols);
}

// gelu_bwd_kernel: the GELU backward of the layer, h = bf16(gelu(hc))
// recomputed, dhc = bf16(bf16(gelu'(hc)) * dh), and part[p][c] = the fp32
// sum of dhc (d fc1 bias) over part p's rows. gelu(x) = x cdf(x), gelu'(x) =
// cdf(x) + x pdf(x): cdf = 0.5 erfc(-x / sqrt 2) by gelu_fit.cuh's Chebyshev
// fit (so h is kernel 9's forward value), pdf by one more `ex2.approx`.
// Below x ~ -4.4 the plain version's 1 + erf(x / sqrt 2) cancels where the
// fit does not: there the two differ by more than a bf16 ulp of the (tiny)
// value, by less than 1e-6 absolute. (Near the zero of gelu', x ~ -0.75,
// cdf and x pdf cancel in both; no bf16 input there lands beyond one ulp.)
//
// What bounds it: bytes (hc, dh read, h, dhc written: 8 bytes an element,
// 404 MB at the training shape, 0.121 ms); in this layout the arithmetic
// stays under the memory time with `erff` and `expf` too (the two forms are
// timed side by side by tools/gelu_colsum_sweep.py).
// The layout and the order of the sums are colsum_kernel's, grid (strips,
// parts) from colsum_config: a lane owns 8 neighbouring columns, one 16-byte
// load of hc and of dh a row, GELU_BWD_ROWS rows of both in flight (64 bytes
// a thread, as the column sum's four rows of one input); h and dhc go out as
// 16-byte streaming stores (`__stcs`). At most 64 registers a thread, so four
// blocks of eight warps stay resident on a multiprocessor and the grid is
// one wave.

constexpr int GELU_BWD_ROWS = 2;

__global__ void __launch_bounds__(32 * COLSUM_MAX_WARPS, 4) gelu_bwd_kernel(
    const bf16* __restrict__ hc, const bf16* __restrict__ dh,
    bf16* __restrict__ h, bf16* __restrict__ dhc, float* __restrict__ part,
    int rows, int cols) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int p = blockIdx.y, parts = gridDim.y;
  const int r0 = (int)((long long)p * rows / parts);
  const int r1 = (int)((long long)(p + 1) * rows / parts);
  const int c0 = blockIdx.x * 256 + 8 * lane;
  float sum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (c0 < cols) {
    for (int r = r0 + warp; r < r1; r += GELU_BWD_ROWS * warps) {
      uint4 xr[GELU_BWD_ROWS], gr[GELU_BWD_ROWS];
#pragma unroll
      for (int k = 0; k < GELU_BWD_ROWS; ++k) {
        if (r + k * warps < r1) {
          const size_t o = (size_t)(r + k * warps) * cols + c0;
          xr[k] = __ldcs(reinterpret_cast<const uint4*>(hc + o));
          gr[k] = __ldcs(reinterpret_cast<const uint4*>(dh + o));
        }
      }
#pragma unroll
      for (int k = 0; k < GELU_BWD_ROWS; ++k) {
        if (r + k * warps < r1) {
          bf16* xv = reinterpret_cast<bf16*>(&xr[k]);
          bf16* gv = reinterpret_cast<bf16*>(&gr[k]);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float x = bf(xv[j]);
            const float e = gelu_fit::erfc_neg(x);
            const float dgelu = rbf(0.5f * e + x * gelu_fit::pdf(x));
            const float d = rbf(dgelu * bf(gv[j]));
            xv[j] = tobf(0.5f * x * e);
            gv[j] = tobf(d);
            sum[j] += d;
          }
          const size_t o = (size_t)(r + k * warps) * cols + c0;
          __stcs(reinterpret_cast<uint4*>(h + o), xr[k]);
          __stcs(reinterpret_cast<uint4*>(dhc + o), gr[k]);
        }
      }
    }
  }
  block_column_partial(sum, part + (size_t)p * cols, cols);
}

// scale_grad_kernel: the LayerScale backward of the layer, dy = bf16(g *
// bf16(ls)) (the product of two bf16 values is exact in fp32, so one
// rounding gives the plain version's bits), and two column sums over part
// p's rows: part[p][0][c] = the fp32 sum of f32(g) * f32(y) (d layer scale),
// part[p][1][c] = that of f32(dy) (d bias of the residual's projection).
//
// What bounds it: bytes (g, y read, dy written: 6 bytes an element, 75.8 MB
// at the training shape, 0.0226 ms). The first kernel took a column a
// thread with 2-byte loads (a warp-wide load moved 64 bytes) and walked 128
// rows one after another on a grid of 3 x 129 blocks: 60% of the memory
// rate. Here the layout and the order of the sums are gelu_bwd_kernel's: a
// lane owns 8 neighbouring columns and keeps their 8 values of bf16(ls) and
// two running sums of 8 in registers, SCALE_GRAD_ROWS rows of g and of y in
// flight as 16-byte streaming loads, dy out as 16-byte streaming stores; the
// grid is colsum_config's, one wave of four blocks of eight warps a
// multiprocessor at most 64 registers a thread. The block writes both sums
// through block_column_partial, and the finishing launch adds the (parts,
// 2, cols) partials. cols % 8 == 0 and every tensor 16-byte aligned are
// checked by the wrapper.

constexpr int SCALE_GRAD_ROWS = 2;

__global__ void __launch_bounds__(32 * COLSUM_MAX_WARPS, 4) scale_grad_kernel(
    const bf16* __restrict__ g, const bf16* __restrict__ y,
    const float* __restrict__ ls, bf16* __restrict__ dy,
    float* __restrict__ part, int rows, int cols) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int p = blockIdx.y, parts = gridDim.y;
  const int r0 = (int)((long long)p * rows / parts);
  const int r1 = (int)((long long)(p + 1) * rows / parts);
  const int c0 = blockIdx.x * 256 + 8 * lane;
  float s_ls[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float s_b[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (c0 < cols) {
    float l[8];
    row::load8(l, ls + c0);
#pragma unroll
    for (int j = 0; j < 8; ++j) l[j] = rbf(l[j]);
    for (int r = r0 + warp; r < r1; r += SCALE_GRAD_ROWS * warps) {
      uint4 gr[SCALE_GRAD_ROWS], yr[SCALE_GRAD_ROWS];
#pragma unroll
      for (int k = 0; k < SCALE_GRAD_ROWS; ++k) {
        if (r + k * warps < r1) {
          const size_t o = (size_t)(r + k * warps) * cols + c0;
          gr[k] = __ldcs(reinterpret_cast<const uint4*>(g + o));
          yr[k] = __ldcs(reinterpret_cast<const uint4*>(y + o));
        }
      }
#pragma unroll
      for (int k = 0; k < SCALE_GRAD_ROWS; ++k) {
        if (r + k * warps < r1) {
          bf16* gv = reinterpret_cast<bf16*>(&gr[k]);
          const bf16* yv = reinterpret_cast<const bf16*>(&yr[k]);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float gf = bf(gv[j]);
            const float d = rbf(gf * l[j]);
            s_ls[j] += gf * bf(yv[j]);
            s_b[j] += d;
            gv[j] = tobf(d);
          }
          __stcs(reinterpret_cast<uint4*>(
                     dy + (size_t)(r + k * warps) * cols + c0),
                 gr[k]);
        }
      }
    }
  }
  float* pp = part + (size_t)p * 2 * cols;
  block_column_partial(s_ls, pp, cols);
  __syncthreads();  // the first sum's shared memory has been read
  block_column_partial(s_b, pp + cols, cols);
}

// out[j] = the sum over p of part[p][j], the finishing launch of every
// column sum: block b owns columns [32 b, +32); warp w of its FINISH_WARPS
// adds parts w, w + FINISH_WARPS, ... of them in order, a lane a column, and
// the warps' sums are added in warp order. The order depends on `parts`
// alone.
constexpr int FINISH_WARPS = 8;

__global__ void __launch_bounds__(32 * FINISH_WARPS) finish_sums_split_kernel(
    const float* __restrict__ part, float* __restrict__ out, int parts,
    int width) {
  __shared__ float red[FINISH_WARPS][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (j < width)
    for (int p = warp; p < parts; p += FINISH_WARPS)
      s += part[(size_t)p * width + j];
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && j < width) {
#pragma unroll
    for (int w = 1; w < FINISH_WARPS; ++w) s += red[w][lane];
    out[j] = s;
  }
}

// ----------------------------- C interface ------------------------------

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

// Launches one type combination of the LayerNorm backward: the block-walk
// kernel (chunks 0) or the warp-per-row kernel with 3 or 4 chunks a lane.
template <typename TX, typename TG, bool ADD>
static void launch_ln_bwd(const void* x, const void* g, const float* scale,
                          const void* residual, void* dx, float* part,
                          int rows, int d, int rpb, float eps, int chunks,
                          int blocks, int warps, cudaStream_t s) {
  const TX *px = (const TX*)x, *pr = (const TX*)residual;
  const TG* pg = (const TG*)g;
  TX* pdx = (TX*)dx;
  if (chunks == 0)
    layer_norm_bwd_kernel<TX, TG, ADD>
        <<<(rows + rpb - 1) / rpb, LN_THREADS, 0, s>>>(
            px, pg, scale, pr, pdx, part, rows, d, rpb, eps);
  else if (chunks <= 3)
    layer_norm_bwd_rows_kernel<TX, TG, ADD, 3><<<blocks, 32 * warps, 0, s>>>(
        px, pg, scale, pr, pdx, part, rows, d, eps);
  else
    layer_norm_bwd_rows_kernel<TX, TG, ADD, 4><<<blocks, 32 * warps, 0, s>>>(
        px, pg, scale, pr, pdx, part, rows, d, eps);
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
// chunks 0: a block of 256 threads walks rpb rows (d <=
// layer_norm_bwd_max_width()); part is ceil(rows / rpb) x 2 x d fp32. Else
// the warp-per-row kernel: chunks = the 8-value chunks a lane holds (d % 8
// == 0, d <= 256 * chunks <= 1024; every tensor 16-byte aligned), `blocks`
// blocks of `warps` (at most 8) warps; part is blocks x 2 x d fp32.
int layer_norm_bwd(const void* x, const void* g, const void* scale,
                   const void* residual, void* dx, void* part, int rows,
                   int d, int rpb, float eps, int mode, int chunks,
                   int blocks, int warps, void* stream) {
  if (chunks != 0 && (chunks < 0 || chunks > 4 || d % 8 != 0 ||
                      d > 256 * chunks || warps < 1 || warps > 8 ||
                      blocks < 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* sc = (const float*)scale;
  float* pt = (float*)part;
  if (mode == 0)
    launch_ln_bwd<bf16, float, true>(x, g, sc, residual, dx, pt, rows, d, rpb,
                                     eps, chunks, blocks, warps, s);
  else if (mode == 1)
    launch_ln_bwd<bf16, bf16, false>(x, g, sc, nullptr, dx, pt, rows, d, rpb,
                                     eps, chunks, blocks, warps, s);
  else
    launch_ln_bwd<float, float, false>(x, g, sc, nullptr, dx, pt, rows, d,
                                       rpb, eps, chunks, blocks, warps, s);
  return (int)cudaGetLastError();
}

// part is parts x 2 x cols fp32; grid (ceil(cols / 256), parts) of `warps`
// warps (cols % 8 == 0, every tensor 16-byte aligned, 1 <= warps <= 8).
int layer_scale_grad(const void* g, const void* y, const void* ls, void* dy,
                     void* part, int rows, int cols, int parts, int warps,
                     void* stream) {
  if (cols % 8 != 0 || parts < 1 || warps < 1 || warps > COLSUM_MAX_WARPS)
    return (int)cudaErrorInvalidValue;
  scale_grad_kernel<<<dim3((cols + 255) / 256, parts), 32 * warps, 0,
                      (cudaStream_t)stream>>>(
      (const bf16*)g, (const bf16*)y, (const float*)ls, (bf16*)dy,
      (float*)part, rows, cols);
  return (int)cudaGetLastError();
}

// part is parts x cols fp32; grid (ceil(cols / 256), parts) of `warps`
// warps (cols % 8 == 0, every tensor 16-byte aligned, 1 <= warps <= 8).
int layer_gelu_bwd(const void* hc, const void* dh, void* h, void* dhc,
                   void* part, int rows, int cols, int parts, int warps,
                   void* stream) {
  if (cols % 8 != 0 || parts < 1 || warps < 1 || warps > COLSUM_MAX_WARPS)
    return (int)cudaErrorInvalidValue;
  gelu_bwd_kernel<<<dim3((cols + 255) / 256, parts), 32 * warps, 0,
                    (cudaStream_t)stream>>>(
      (const bf16*)hc, (const bf16*)dh, (bf16*)h, (bf16*)dhc, (float*)part,
      rows, cols);
  return (int)cudaGetLastError();
}

// part is parts x cols fp32; grid (ceil(cols / 256), parts) of `warps`
// warps (cols % 8 == 0, a 16-byte aligned, 1 <= warps <= 8).
int layer_colsum(const void* a, void* part, int rows, int cols, int parts,
                 int warps, void* stream) {
  if (cols % 8 != 0 || parts < 1 || warps < 1 || warps > COLSUM_MAX_WARPS)
    return (int)cudaErrorInvalidValue;
  colsum_kernel<<<dim3((cols + 255) / 256, parts), 32 * warps, 0,
                  (cudaStream_t)stream>>>((const bf16*)a, (float*)part, rows,
                                          cols);
  return (int)cudaGetLastError();
}

// out (width,) = the sum of part (parts, width) over its parts (see the
// kernel).
int layer_finish_sums(const void* part, void* out, int parts, int width,
                      void* stream) {
  finish_sums_split_kernel<<<(width + 31) / 32, 32 * FINISH_WARPS, 0,
                             (cudaStream_t)stream>>>((const float*)part,
                                                     (float*)out, parts,
                                                     width);
  return (int)cudaGetLastError();
}

int layer_finish_split() { return FINISH_WARPS; }

}  // extern "C"
