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
// weight read (~51 us at 3.35 TB/s). This first version is the simple,
// right one: WMMA bf16 tiles with fp32 accumulators, staged through shared
// memory with no pipelining; K and V of one head held in shared memory for
// attention. TMA/wgmma pipelines and a persistent kernel are later work.
//
// The training layer (hypervla_tpu_torch/ops/dino_layer_train.py) and the
// training LayerNorm (ops/layer_norm.py) launch the same LayerNorm and GEMM
// at M = B*S rows: for them the LayerNorm also takes fp32 rows, and the
// GEMM has a second output, a no-bias form and an fp32 output (below).
//
// Plain C interface (loaded with ctypes). Every entry point launches on the
// given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 tobf(float v) { return __float2bfloat16_rn(v); }
// round an fp32 value to the nearest bf16 and back
__device__ __forceinline__ float rbf(float v) { return bf(tobf(v)); }

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

// ------------------------------- LayerNorm -------------------------------
// One block per row. flax fast variance: var = max(E[x^2] - mu^2, 0), then
// ((x - mu) * rsqrt(var + eps)) * scale + bias in fp32, rounded once to the
// input's type T (bf16 in the trunks; fp32 too for the training LayerNorm
// of ops/layer_norm.py, whose forward this kernel is).

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
// fc2 keeps W2^T and contracts on its dim 1. Block tile 64x64x32, four
// warps of 32x32, WMMA 16x16x16 bf16 with fp32 accumulators. Rows past M
// are masked; N % 64 == 0 and K % 32 == 0 are checked by the wrapper.
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

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int GEMM_THREADS = 128;
constexpr int SPAD = 8;  // shared-memory row pad, in bf16 elements
enum { EPI_NONE = 0, EPI_GELU = 1, EPI_RESIDUAL = 2, EPI_F32 = 3 };

template <bool TRANS_B, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(
    const bf16* __restrict__ A, int lda, const bf16* __restrict__ B, int ldb,
    const float* __restrict__ bias, const bf16* __restrict__ residual,
    const float* __restrict__ layer_scale, void* __restrict__ out,
    bf16* __restrict__ out2, int M, int N, int K) {
  __shared__ __align__(128) bf16 As[BM][BK + SPAD];
  __shared__ __align__(128)
      bf16 Bs[TRANS_B ? BN : BK][TRANS_B ? BK + SPAD : BN + SPAD];
  __shared__ __align__(128) float Cs[BM][BN + 4];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: 64 rows x 32 cols = 256 16-byte vectors, 2 per thread
#pragma unroll
    for (int v = tid; v < BM * BK / 8; v += GEMM_THREADS) {
      const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M)
        val = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * lda +
                                              k0 + c);
      *reinterpret_cast<uint4*>(&As[r][c]) = val;
    }
    if (TRANS_B) {
      // B^T tile: 64 (n) rows x 32 (k) cols
#pragma unroll
      for (int v = tid; v < BN * BK / 8; v += GEMM_THREADS) {
        const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
        *reinterpret_cast<uint4*>(&Bs[r][c]) =
            *reinterpret_cast<const uint4*>(B + (size_t)(n0 + r) * ldb + k0 +
                                            c);
      }
    } else {
      // B tile: 32 (k) rows x 64 (n) cols
#pragma unroll
      for (int v = tid; v < BK * BN / 8; v += GEMM_THREADS) {
        const int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
        *reinterpret_cast<uint4*>(&Bs[r][c]) =
            *reinterpret_cast<const uint4*>(B + (size_t)(k0 + r) * ldb + n0 +
                                            c);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      typedef typename std::conditional<TRANS_B, wmma::col_major,
                                        wmma::row_major>::type BLayout;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[wm + 16 * i][kk], BK + SPAD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (TRANS_B)
          wmma::load_matrix_sync(b[j], &Bs[wn + 16 * j][kk], BK + SPAD);
        else
          wmma::load_matrix_sync(b[j], &Bs[kk][wn + 16 * j], BN + SPAD);
      }
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
                              BN + 4, wmma::mem_row_major);
  __syncthreads();

  for (int idx = tid; idx < BM * BN; idx += GEMM_THREADS) {
    const int r = idx / BN, c = idx % BN;
    const int m = m0 + r, n = n0 + c;
    if (m >= M) continue;
    const size_t o = (size_t)m * N + n;
    if (EPI == EPI_F32) {
      static_cast<float*>(out)[o] = Cs[r][c];
      continue;
    }
    float y = rbf(Cs[r][c]);
    if (bias) y = rbf(y + rbf(bias[n]));
    if (EPI != EPI_NONE && out2) out2[o] = tobf(y);
    if (EPI == EPI_GELU) {
      y = rbf(y * (0.5f * (1.f + erff(y * 0.70710678118654752f))));
    } else if (EPI == EPI_RESIDUAL) {
      const float t = rbf(rbf(layer_scale[n]) * y);
      y = rbf(bf(residual[o]) + t);
    }
    static_cast<bf16*>(out)[o] = tobf(y);
  }
}

// ------------------------------- Attention -------------------------------
// Softmax attention of one head over all S tokens, head dim 64, no mask.
// One block per (head, 32 query rows); K and V of the head sit in dynamic
// shared memory (rows padded to 66 bf16 so lanes reading different keys
// hit different banks). One warp per query row: q is scaled by 0.125 in
// bf16; each score is an fp32 dot rounded to bf16; softmax in fp32 with the
// probabilities rounded to bf16; P.V summed in fp32, rounded to bf16.

constexpr int HD = 64;
constexpr int KV_LD = HD + 2;
constexpr int ATT_WARPS = 8;
constexpr int ATT_ROWS = 32;

__global__ void __launch_bounds__(ATT_WARPS * 32) attention_kernel(
    const bf16* __restrict__ qkv, bf16* __restrict__ out, int S,
    int hidden) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + (size_t)S * KV_LD;
  float* Ps = reinterpret_cast<float*>(Vs + (size_t)S * KV_LD);
  const int h = blockIdx.x;
  const int row0 = blockIdx.y * ATT_ROWS;
  const int ld = 3 * hidden;

  for (int i = threadIdx.x; i < S * (HD / 2); i += blockDim.x) {
    const int s = i / (HD / 2), c = (i % (HD / 2)) * 2;
    const bf16* src = qkv + (size_t)s * ld + h * HD + c;
    *reinterpret_cast<uint32_t*>(&Ks[s * KV_LD + c]) =
        *reinterpret_cast<const uint32_t*>(src + hidden);
    *reinterpret_cast<uint32_t*>(&Vs[s * KV_LD + c]) =
        *reinterpret_cast<const uint32_t*>(src + 2 * hidden);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* p = Ps + (size_t)warp * S;
  for (int r = warp; r < ATT_ROWS; r += ATT_WARPS) {
    const int m = row0 + r;
    if (m >= S) break;
    const bf16* qrow = qkv + (size_t)m * ld + h * HD;
    float q[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) q[d] = rbf(bf(qrow[d]) * 0.125f);

    float mx = -INFINITY;
    for (int j = lane; j < S; j += 32) {
      const bf16* kr = Ks + (size_t)j * KV_LD;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < HD; d += 2) {
        const __nv_bfloat162 kv =
            *reinterpret_cast<const __nv_bfloat162*>(kr + d);
        acc = fmaf(q[d], __low2float(kv), acc);
        acc = fmaf(q[d + 1], __high2float(kv), acc);
      }
      const float sc = rbf(acc);
      p[j] = sc;
      mx = fmaxf(mx, sc);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(p[j] - mx);
      p[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < S; j += 32) p[j] = rbf(p[j] / sum);
    __syncwarp();

    float o0 = 0.f, o1 = 0.f;
    for (int j = 0; j < S; ++j) {
      const float pj = p[j];
      const __nv_bfloat162 vv = *reinterpret_cast<const __nv_bfloat162*>(
          Vs + (size_t)j * KV_LD + 2 * lane);
      o0 = fmaf(pj, __low2float(vv), o0);
      o1 = fmaf(pj, __high2float(vv), o1);
    }
    *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * hidden + h * HD +
                                       2 * lane) =
        __floats2bfloat162_rn(o0, o1);
    __syncwarp();
  }
}

// ----------------------------- C interface ------------------------------

template <bool TRANS_B>
static void launch_gemm(int epilogue, dim3 grid, cudaStream_t stream,
                        const bf16* a, int lda, const bf16* b, int ldb,
                        const float* bias, const bf16* residual,
                        const float* layer_scale, void* out, bf16* out2,
                        int m, int n, int k) {
  switch (epilogue) {
    case EPI_GELU:
      gemm_kernel<TRANS_B, EPI_GELU><<<grid, GEMM_THREADS, 0, stream>>>(
          a, lda, b, ldb, bias, residual, layer_scale, out, out2, m, n, k);
      break;
    case EPI_RESIDUAL:
      gemm_kernel<TRANS_B, EPI_RESIDUAL><<<grid, GEMM_THREADS, 0, stream>>>(
          a, lda, b, ldb, bias, residual, layer_scale, out, out2, m, n, k);
      break;
    case EPI_F32:
      gemm_kernel<TRANS_B, EPI_F32><<<grid, GEMM_THREADS, 0, stream>>>(
          a, lda, b, ldb, bias, residual, layer_scale, out, out2, m, n, k);
      break;
    default:
      gemm_kernel<TRANS_B, EPI_NONE><<<grid, GEMM_THREADS, 0, stream>>>(
          a, lda, b, ldb, bias, residual, layer_scale, out, out2, m, n, k);
  }
}

extern "C" {

// x and out are fp32 with `is_f32`, else bf16.
int dino_layer_norm(const void* x, const void* scale, const void* bias,
                    void* out, int rows, int d, float eps, int is_f32,
                    void* stream) {
  if (is_f32)
    layer_norm_kernel<float><<<rows, LN_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)scale, (const float*)bias,
        (float*)out, d, eps);
  else
    layer_norm_kernel<bf16><<<rows, LN_THREADS, 0, (cudaStream_t)stream>>>(
        (const bf16*)x, (const float*)scale, (const float*)bias, (bf16*)out,
        d, eps);
  return (int)cudaGetLastError();
}

int dino_gemm(const void* a, int lda, const void* b, int ldb, int trans_b,
              const void* bias, const void* residual, const void* layer_scale,
              void* out, void* out2, int m, int n, int k, int epilogue,
              void* stream) {
  const dim3 grid(n / BN, (m + BM - 1) / BM);
  if (trans_b)
    launch_gemm<true>(epilogue, grid, (cudaStream_t)stream, (const bf16*)a,
                      lda, (const bf16*)b, ldb, (const float*)bias,
                      (const bf16*)residual, (const float*)layer_scale, out,
                      (bf16*)out2, m, n, k);
  else
    launch_gemm<false>(epilogue, grid, (cudaStream_t)stream, (const bf16*)a,
                       lda, (const bf16*)b, ldb, (const float*)bias,
                       (const bf16*)residual, (const float*)layer_scale, out,
                       (bf16*)out2, m, n, k);
  return (int)cudaGetLastError();
}

int dino_attention(const void* qkv, void* out, int seq, int hidden,
                   void* stream) {
  const size_t smem = (size_t)2 * seq * KV_LD * sizeof(bf16) +
                      (size_t)ATT_WARPS * seq * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(hidden / HD, (seq + ATT_ROWS - 1) / ATT_ROWS);
  attention_kernel<<<grid, ATT_WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const bf16*)qkv, (bf16*)out, seq, hidden);
  return (int)cudaGetLastError();
}

}  // extern "C"
