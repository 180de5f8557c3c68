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
// finishing launch that adds them in a fixed order, and a weight gradient
// tile is owned by one block that walks all rows. Results repeat bit for
// bit. What bounds the layer backward on this card is the GEMM work (~466
// GFLOP at B=64 against ~1 GB moved): this first version uses the WMMA tiles
// of dino_layer.cu (64x64 outputs, unpipelined); wgmma/TMA pipelines and a
// split over rows for the small weight gradients are later work.
//
// Plain C interface (loaded with ctypes). Every entry point launches on the
// given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 tobf(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ float rbf(float v) { return bf(tobf(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------ A^T B GEMM ------------------------------
// out[K1, N] = bf16(A[M, K1]^T @ B[M, N]): A and B row-major with row
// strides lda, ldb, contracted over their M rows. One block owns a 64x64
// output tile and walks all M rows 32 at a time (rows past M read as zero),
// four warps of 32x32, WMMA 16x16x16 bf16 with fp32 accumulators; A's tile
// is staged as it lies in memory and read as a col-major matrix_a fragment,
// so no transposed copy exists. K1 % 64 == 0 and N % 64 == 0 are checked by
// the wrapper.

constexpr int TM = 64, TN = 64, TK = 32;
constexpr int GEMM_THREADS = 128;
constexpr int SPAD = 8;  // shared-memory row pad, in bf16 elements

__global__ void __launch_bounds__(GEMM_THREADS) gemm_tn_kernel(
    const bf16* __restrict__ A, int lda, const bf16* __restrict__ B, int ldb,
    bf16* __restrict__ out, int M, int N) {
  __shared__ __align__(128) bf16 As[TK][TM + SPAD];
  __shared__ __align__(128) bf16 Bs[TK][TN + SPAD];
  __shared__ __align__(128) float Cs[TM][TN + 4];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int i0 = blockIdx.y * TM, n0 = blockIdx.x * TN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int m0 = 0; m0 < M; m0 += TK) {
    // 32 rows x 64 cols of each operand = 256 16-byte vectors, 2 per thread
#pragma unroll
    for (int v = tid; v < TK * TM / 8; v += GEMM_THREADS) {
      const int r = v / (TM / 8), c = (v % (TM / 8)) * 8;
      uint4 va = make_uint4(0u, 0u, 0u, 0u), vb = va;
      if (m0 + r < M) {
        va = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * lda + i0 +
                                             c);
        vb = *reinterpret_cast<const uint4*>(B + (size_t)(m0 + r) * ldb + n0 +
                                             c);
      }
      *reinterpret_cast<uint4*>(&As[r][c]) = va;
      *reinterpret_cast<uint4*>(&Bs[r][c]) = vb;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[kk][wm + 16 * i], TM + SPAD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[kk][wn + 16 * j], TN + SPAD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm + 16 * i][wn + 16 * j], acc[i][j],
                              TN + 4, wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < TM * TN; idx += GEMM_THREADS) {
    const int r = idx / TN, c = idx % TN;
    out[(size_t)(i0 + r) * N + n0 + c] = tobf(Cs[r][c]);
  }
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

extern "C" {

int layer_gemm_tn(const void* a, int lda, const void* b, int ldb, void* out,
                  int m, int k1, int n, void* stream) {
  const dim3 grid(n / TN, k1 / TM);
  gemm_tn_kernel<<<grid, GEMM_THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)a, lda, (const bf16*)b, ldb, (bf16*)out, m, n);
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
