// Row and elementwise kernels of the DINOv2 trunks for Hopper (sm_90a):
//
//   row_layer_norm        the one-pass serving LayerNorm. Replaces the Pallas
//                         TPU kernel hypervla_tpu/ops/layer_norm.py::layer_norm
//                         (body `_ln_kernel`): fp32 statistics on the input as
//                         it comes, the two-pass variance mean((x - mean)^2),
//                         one rounding to the input's type; scale and bias
//                         fp32, or bf16 as the serving step stores them
//                         (widened on read, so no cast launches).
//   row_add_ln_fwd        (x + delta, LN(x + delta)) and, with a LayerScale
//                         vector, (x + ls * delta, LN(.)). Replaces
//                         hypervla_tpu/ops/add_layer_norm.py::fused_add_ln and
//                         ::fused_add_scale_ln (bodies `_fwd_kernel`,
//                         `_fwd_scale_kernel`): ls is cast to x's type, the
//                         multiply and the add are each rounded to x's type,
//                         the statistics are flax's fast variance
//                         max(E[x^2] - mean^2, 0) in fp32 from the rounded sum,
//                         y is rounded once.
//   row_add_ln_bwd        their backward (`_bwd_kernel`, `_bwd_scale_kernel`):
//                         dx_new = inv * (gs - mean(gs) - xhat * mean(gs * xhat))
//                         + g_xnew in fp32, rounded once; ddelta = dx_new (fp32)
//                         * ls (fp32), rounded once; per-block column sums of
//                         g_y * xhat, g_y and dx_new * delta (dscale, dbias,
//                         dls). The statistics are recomputed from x_new.
//   row_gelu              exact GELU, 0.5 * x * erfc(-x / sqrt 2) in fp32,
//                         rounded once. Replaces hypervla_tpu/ops/gelu.py::
//                         gelu_exact_fused (`_gelu_kernel`), whose rational
//                         polynomial stands in for the erf that its compiler
//                         lacks (see the note at the kernel for the erfc here).
//
// All of them are bound by bytes on this card: every input is read once and
// every output written once, with a few dozen fp32 operations per element.
// The row kernels keep a row in registers between its passes (thread t owns
// columns t, t + 256, ...: d <= 2048), so device memory sees one read and
// one write. The TPU kernels' 128- and 1024-row blocks and their sequential
// grid with a VMEM accumulator are not carried over: the forward kernels
// take one block per row; the backward walks `rpb` rows per block and leaves
// per-block fp32 partial sums that a finishing launch adds in a fixed order
// (layer_backward.cu's layer_finish_sums), so there are no atomics and two
// runs give the same bits.
//
// Plain C interface (loaded with ctypes). Every entry point launches on the
// given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 tobf(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float ld(const bf16* p) { return bf(*p); }
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ void st(bf16* p, float v) { *p = tobf(v); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
// round an fp32 value to T and back
template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<bf16>(float v) { return bf(tobf(v)); }
template <>
__device__ __forceinline__ float rnd<float>(float v) { return v; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr int ROW_THREADS = 256;
constexpr int ROW_MAXC = 8;  // columns per thread: d <= 2048

// Sums a and b over the block; every thread adds the warps' sums in the
// same order, so all of them hold the same bits.
__device__ __forceinline__ void block_sum2(float& a, float& b,
                                           float (*red)[ROW_THREADS / 32]) {
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
  for (int w = 0; w < ROW_THREADS / 32; ++w) {
    a += red[0][w];
    b += red[1][w];
  }
}

// --------------------- the one-pass serving LayerNorm ---------------------
// One block per row. mean = E[x]; var = E[(x - mean)^2] (two passes over the
// row held in registers); y = ((x - mean) * rsqrt(var + eps)) * scale + bias.
// scale and bias are fp32, or bf16 as the serving step stores them (TV).

template <typename T, typename TV>
__global__ void __launch_bounds__(ROW_THREADS) layer_norm_two_pass_kernel(
    const T* __restrict__ x, const TV* __restrict__ scale,
    const TV* __restrict__ bias, T* __restrict__ out, int d, float eps) {
  __shared__ float red[2][ROW_THREADS / 32];
  const size_t base = (size_t)blockIdx.x * d;
  const int tid = threadIdx.x;
  float xv[ROW_MAXC];
  float s = 0.f, unused = 0.f;
#pragma unroll
  for (int j = 0; j < ROW_MAXC; ++j) {
    const int c = tid + j * ROW_THREADS;
    xv[j] = c < d ? ld(x + base + c) : 0.f;
    s += xv[j];
  }
  block_sum2(s, unused, red);
  const float mu = s / (float)d;
  float s2 = 0.f;
#pragma unroll
  for (int j = 0; j < ROW_MAXC; ++j) {
    const int c = tid + j * ROW_THREADS;
    if (c < d) {
      xv[j] -= mu;
      s2 += xv[j] * xv[j];
    }
  }
  block_sum2(s2, unused, red);
  const float rs = rsqrtf(s2 / (float)d + eps);
#pragma unroll
  for (int j = 0; j < ROW_MAXC; ++j) {
    const int c = tid + j * ROW_THREADS;
    if (c < d)
      st(out + base + c, (xv[j] * rs) * ld(scale + c) + ld(bias + c));
  }
}

// ------------------- residual add + LayerNorm, forward -------------------
// One block per row. HAS_LS: x_new = rnd(x + rnd(rnd(ls) * delta)), else
// x_new = rnd(x + delta), rnd to T (the explicit round-to-nearest intrinsics
// keep the compiler from contracting the multiply and the add into one
// FMA). Statistics from the rounded x_new.

template <typename T, bool HAS_LS>
__global__ void __launch_bounds__(ROW_THREADS) add_ln_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ delta,
    const float* __restrict__ ls, const float* __restrict__ scale,
    const float* __restrict__ bias, T* __restrict__ xn, T* __restrict__ y,
    int d, float eps) {
  __shared__ float red[2][ROW_THREADS / 32];
  const size_t base = (size_t)blockIdx.x * d;
  const int tid = threadIdx.x;
  float v[ROW_MAXC];
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int j = 0; j < ROW_MAXC; ++j) {
    const int c = tid + j * ROW_THREADS;
    v[j] = 0.f;
    if (c < d) {
      float dl = ld(delta + base + c);
      if (HAS_LS) dl = rnd<T>(__fmul_rn(rnd<T>(ls[c]), dl));
      v[j] = rnd<T>(__fadd_rn(ld(x + base + c), dl));
      st(xn + base + c, v[j]);
    }
    s += v[j];
    s2 += v[j] * v[j];
  }
  block_sum2(s, s2, red);
  const float mu = s / (float)d;
  const float var = fmaxf(s2 / (float)d - mu * mu, 0.f);
  const float rs = rsqrtf(var + eps);
#pragma unroll
  for (int j = 0; j < ROW_MAXC; ++j) {
    const int c = tid + j * ROW_THREADS;
    if (c < d) st(y + base + c, ((v[j] - mu) * rs) * scale[c] + bias[c]);
  }
}

// ------------------- residual add + LayerNorm, backward -------------------
// One block walks rows [blockIdx.x * rpb, +rpb). gy or gxn may be null (a
// cotangent that does not exist reads as zero). part[block][sum][d]: sums
// of gy * xhat, gy and, with HAS_LS, dx_new * delta.

template <typename T, bool HAS_LS>
__global__ void __launch_bounds__(ROW_THREADS) add_ln_bwd_kernel(
    const T* __restrict__ gy, const T* __restrict__ gxn,
    const T* __restrict__ xn, const T* __restrict__ delta,
    const float* __restrict__ ls, const float* __restrict__ scale,
    T* __restrict__ dxn, T* __restrict__ dd, float* __restrict__ part,
    int rows, int d, int rpb, float eps) {
  __shared__ float red[2][ROW_THREADS / 32];
  constexpr int SUMS = HAS_LS ? 3 : 2;
  const int tid = threadIdx.x;
  float sc[ROW_MAXC], lsv[ROW_MAXC];
  float sum_gx[ROW_MAXC], sum_g[ROW_MAXC], sum_ls[ROW_MAXC];
#pragma unroll
  for (int j = 0; j < ROW_MAXC; ++j) {
    const int c = tid + j * ROW_THREADS;
    sc[j] = c < d ? scale[c] : 0.f;
    lsv[j] = (HAS_LS && c < d) ? ls[c] : 0.f;
    sum_gx[j] = 0.f;
    sum_g[j] = 0.f;
    sum_ls[j] = 0.f;
  }
  const int row0 = blockIdx.x * rpb;
  const int row1 = min(rows, row0 + rpb);
  for (int r = row0; r < row1; ++r) {
    const size_t base = (size_t)r * d;
    float xv[ROW_MAXC], gv[ROW_MAXC];
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < ROW_MAXC; ++j) {
      const int c = tid + j * ROW_THREADS;
      xv[j] = c < d ? ld(xn + base + c) : 0.f;
      gv[j] = (gy != nullptr && c < d) ? ld(gy + base + c) : 0.f;
      s += xv[j];
      s2 += xv[j] * xv[j];
    }
    block_sum2(s, s2, red);
    const float mu = s / (float)d;
    const float var = fmaxf(s2 / (float)d - mu * mu, 0.f);
    const float rs = rsqrtf(var + eps);
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int j = 0; j < ROW_MAXC; ++j) {
      const int c = tid + j * ROW_THREADS;
      if (c < d) {
        const float xhat = (xv[j] - mu) * rs;
        const float gs = gv[j] * sc[j];
        sum_gx[j] += gv[j] * xhat;
        sum_g[j] += gv[j];
        a += gs;
        b += gs * xhat;
        xv[j] = xhat;
        gv[j] = gs;
      }
    }
    block_sum2(a, b, red);
    const float m1 = a / (float)d, m2 = b / (float)d;
#pragma unroll
    for (int j = 0; j < ROW_MAXC; ++j) {
      const int c = tid + j * ROW_THREADS;
      if (c < d) {
        float v = rs * (gv[j] - m1 - xv[j] * m2);
        if (gxn != nullptr) v += ld(gxn + base + c);
        st(dxn + base + c, v);
        if (HAS_LS) {
          st(dd + base + c, v * lsv[j]);
          sum_ls[j] += v * ld(delta + base + c);
        }
      }
    }
  }
  float* p = part + (size_t)blockIdx.x * SUMS * d;
#pragma unroll
  for (int j = 0; j < ROW_MAXC; ++j) {
    const int c = tid + j * ROW_THREADS;
    if (c < d) {
      p[c] = sum_gx[j];
      p[d + c] = sum_g[j];
      if (HAS_LS) p[2 * d + c] = sum_ls[j];
    }
  }
}

// ------------------------------- exact GELU -------------------------------
// What bounds it: bytes (one read and one write of 2 bytes an element, 202 MB
// at the training shape: 0.060 ms), with the arithmetic close behind: CUDA's
// erfcf is ~45 instructions an element, so a kernel that evaluates it on one
// 16-byte vector before it asks for the next leaves the memory idle. Here a
// thread requests GELU_VECS 16-byte vectors (64 bytes of bf16) before any
// arithmetic, the blocks make one pass over the tensor (no grid stride), the
// loads and stores stream past the L1 (`__ldcs`, `__stcs`: the output is
// not read again before the next GEMM), and erfc is Numerical Recipes'
// Chebyshev fit `erfcc`, erfc(a) = t exp(-a^2 + P(t)) with t = 1 / (1 + a/2)
// for a >= 0 (fractional error < 1.2e-7 everywhere), on the fast reciprocal
// and `ex2.approx`: ~20 instructions. Against 0.5 x erfc(-x / sqrt 2) with
// erfcf it is within one bf16 ulp of the value at every finite bf16 input
// (subnormal outputs included: the non-ftz ex2 keeps them) and within 1e-6
// of the output scale in fp32.

constexpr int GELU_THREADS = 256;
constexpr int GELU_VECS = 4;

__device__ __forceinline__ float fast_rcp(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float fast_exp2(float v) {
  float r;
  asm("ex2.approx.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float gelu_exact(float x) {
  const float z = -x * 0.70710678118654752f;  // gelu(x) = 0.5 x erfc(z)
  const float a = fabsf(z);
  const float t = fast_rcp(fmaf(0.5f, a, 1.f));
  float p = 0.17087277f;
  p = fmaf(p, t, -0.82215223f);
  p = fmaf(p, t, 1.48851587f);
  p = fmaf(p, t, -1.13520398f);
  p = fmaf(p, t, 0.27886807f);
  p = fmaf(p, t, -0.18628806f);
  p = fmaf(p, t, 0.09678418f);
  p = fmaf(p, t, 0.37409196f);
  p = fmaf(p, t, 1.00002368f);
  p = fmaf(p, t, -1.26551223f);
  const float e = t * fast_exp2(fmaf(-a, a, p) * 1.44269504088896341f);
  return 0.5f * x * (z < 0.f ? 2.f - e : e);
}

// n elements. With `vectors` > 0 (x and out 16-byte aligned) the first
// vectors * (16 / sizeof(T)) go as 16-byte loads and stores, GELU_VECS of
// them a thread, thread t of block b taking vectors 1024 b + t + 256 k (a
// warp's loads cover 512 contiguous bytes); the rest go one by one.
template <typename T>
__global__ void __launch_bounds__(GELU_THREADS) gelu_kernel(
    const T* __restrict__ x, T* __restrict__ out, long long n,
    long long vectors) {
  constexpr int VEC = 16 / sizeof(T);
  const long long first =
      (long long)blockIdx.x * GELU_THREADS * GELU_VECS + threadIdx.x;
  uint4 raw[GELU_VECS];
#pragma unroll
  for (int k = 0; k < GELU_VECS; ++k) {
    const long long i = first + k * GELU_THREADS;
    if (i < vectors) raw[k] = __ldcs(reinterpret_cast<const uint4*>(x) + i);
  }
#pragma unroll
  for (int k = 0; k < GELU_VECS; ++k) {
    const long long i = first + k * GELU_THREADS;
    if (i < vectors) {
      T* vals = reinterpret_cast<T*>(&raw[k]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) st(vals + j, gelu_exact(ld(vals + j)));
      __stcs(reinterpret_cast<uint4*>(out) + i, raw[k]);
    }
  }
  const long long stride = (long long)gridDim.x * GELU_THREADS;
  for (long long i = vectors * VEC + (long long)blockIdx.x * GELU_THREADS +
                     threadIdx.x;
       i < n; i += stride)
    st(out + i, gelu_exact(ld(x + i)));
}

// ----------------------------- C interface ------------------------------

extern "C" {

// The widest row the row kernels take.
int row_max_width() { return ROW_THREADS * ROW_MAXC; }

// is_f32: x and out fp32, else bf16. vec_f32: scale and bias (d,) fp32,
// else bf16.
int row_layer_norm(const void* x, const void* scale, const void* bias,
                   void* out, int rows, int d, float eps, int is_f32,
                   int vec_f32, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define LAYER_NORM(T, TV)                                               \
  layer_norm_two_pass_kernel<T, TV><<<rows, ROW_THREADS, 0, s>>>(        \
      (const T*)x, (const TV*)scale, (const TV*)bias, (T*)out, d, eps)
  if (is_f32) {
    if (vec_f32) LAYER_NORM(float, float); else LAYER_NORM(float, bf16);
  } else {
    if (vec_f32) LAYER_NORM(bf16, float); else LAYER_NORM(bf16, bf16);
  }
#undef LAYER_NORM
  return (int)cudaGetLastError();
}

// ls null: x_new = x + delta; else x_new = x + ls * delta. x, delta, xn, y
// in one type (fp32 with is_f32, else bf16); ls, scale, bias fp32 (d,).
int row_add_ln_fwd(const void* x, const void* delta, const void* ls,
                   const void* scale, const void* bias, void* xn, void* y,
                   int rows, int d, float eps, int is_f32, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define ADD_LN_FWD(T, HAS_LS)                                              \
  add_ln_fwd_kernel<T, HAS_LS><<<rows, ROW_THREADS, 0, s>>>(                \
      (const T*)x, (const T*)delta, (const float*)ls, (const float*)scale,  \
      (const float*)bias, (T*)xn, (T*)y, d, eps)
  if (is_f32) {
    if (ls) ADD_LN_FWD(float, true); else ADD_LN_FWD(float, false);
  } else {
    if (ls) ADD_LN_FWD(bf16, true); else ADD_LN_FWD(bf16, false);
  }
#undef ADD_LN_FWD
  return (int)cudaGetLastError();
}

// ls null: no LayerScale (delta, dd unused; part is blocks x 2 x d); else
// part is blocks x 3 x d, blocks = ceil(rows / rpb). gy, gxn may be null.
int row_add_ln_bwd(const void* gy, const void* gxn, const void* xn,
                   const void* delta, const void* ls, const void* scale,
                   void* dxn, void* dd, void* part, int rows, int d, int rpb,
                   float eps, int is_f32, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = (rows + rpb - 1) / rpb;
#define ADD_LN_BWD(T, HAS_LS)                                               \
  add_ln_bwd_kernel<T, HAS_LS><<<grid, ROW_THREADS, 0, s>>>(                 \
      (const T*)gy, (const T*)gxn, (const T*)xn, (const T*)delta,            \
      (const float*)ls, (const float*)scale, (T*)dxn, (T*)dd, (float*)part,  \
      rows, d, rpb, eps)
  if (is_f32) {
    if (ls) ADD_LN_BWD(float, true); else ADD_LN_BWD(float, false);
  } else {
    if (ls) ADD_LN_BWD(bf16, true); else ADD_LN_BWD(bf16, false);
  }
#undef ADD_LN_BWD
  return (int)cudaGetLastError();
}

// aligned: x and out are 16-byte aligned, so whole vectors go as 16 bytes.
// One block a GELU_THREADS * GELU_VECS vectors (or, unaligned, elements).
int row_gelu(const void* x, void* out, long long n, int aligned, int is_f32,
             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int vec = is_f32 ? 4 : 8;
  const long long vectors = aligned ? n / vec : 0;
  const long long work = vectors > 0 ? vectors : n;
  const long long per_block = (long long)GELU_THREADS * GELU_VECS;
  long long blocks = (work + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (is_f32)
    gelu_kernel<float><<<(int)blocks, GELU_THREADS, 0, s>>>(
        (const float*)x, (float*)out, n, vectors);
  else
    gelu_kernel<bf16><<<(int)blocks, GELU_THREADS, 0, s>>>(
        (const bf16*)x, (bf16*)out, n, vectors);
  return (int)cudaGetLastError();
}

}  // extern "C"
