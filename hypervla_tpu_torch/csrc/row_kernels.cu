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
//                         lacks (the erfc here: gelu_fit.cuh).
//
// All of them are bound by bytes on this card: every input is read once and
// every output written once, with a few dozen fp32 operations per element.
// The one-pass LayerNorm and the residual add + LayerNorm pair hold a row in
// the registers of one warp (csrc/row_vec.cuh: a lane owns chunks of eight
// neighbouring values, 16-byte loads, the row's sums by shuffles, no barrier
// in the row loop) where the width allows it (d a multiple of 8 up to 1024,
// every tensor 16-byte aligned: the wrappers choose, ops/layer_norm.py and
// ops/add_layer_norm.py, by kernel 6's plan); at other widths they keep a
// row in the registers of a block (thread t owns columns t, t + 256, ...: d
// <= 2048). Device memory sees one read and one write either way. The TPU kernels' 128- and
// 1024-row blocks and their sequential grid with a VMEM accumulator are not
// carried over: the backward's column sums are per-block fp32 partials that
// a finishing launch adds in a fixed order (layer_backward.cu's
// layer_finish_sums), so there are no atomics and two runs give the same
// bits.
//
// Plain C interface (loaded with ctypes). Every entry point launches on the
// given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "gelu_fit.cuh"
#include "row_vec.cuh"

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
// mean = E[x]; var = E[(x - mean)^2] (two passes over the row held in
// registers); y = ((x - mean) * rsqrt(var + eps)) * scale + bias, rounded
// once. scale and bias are fp32, or bf16 as the serving step stores them
// (TV).
//
// What bounds it: at the serving shape (257 rows of 768) the row is 1.5 KB
// and the whole call 0.8 MB, so latency, not bytes: the chain of dependent
// steps from the first load to the last store. The first kernel
// (layer_norm_two_pass_kernel, kept for the other widths) takes a block of
// 256 threads a row, three 2-byte loads a thread, two block reductions (four
// barriers), and loads scale and bias only in its store loop, a second
// memory round trip at the tail. layer_norm_one_pass_rows_kernel takes a
// warp a row, CH chunks of eight values a lane (row_vec.cuh): every load of
// the lane (its x chunks, its chunks of scale and bias) is requested before
// any is used, so the row costs one round trip; the mean is one shuffle
// tree, the centred values stay in registers and their squares take a
// second; the result leaves as 16-byte stores, with no barrier. What is
// left is the chain of dependent operations, so a lane adds its values as
// eight running sums over its chunks and then pairwise (CH + 3 adds deep,
// where one running sum was 8 CH). Warp w of the grid walks rows w, w +
// (warps of the grid), ... (ops/layer_norm.py::layer_norm_plan: at 257
// rows, 65 blocks of four warps).

// grid: any number of blocks of 32 * warps threads.
template <typename T, typename TV, int CH>
__global__ void __launch_bounds__(256) layer_norm_one_pass_rows_kernel(
    const T* __restrict__ x, const TV* __restrict__ scale,
    const TV* __restrict__ bias, T* __restrict__ out, int rows, int d,
    float eps) {
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int stride = gridDim.x * warps;
  const int chunks = d >> 3;
  for (int r = blockIdx.x * warps + (threadIdx.x >> 5); r < rows;
       r += stride) {
    row::Raw<T> xr[CH];
    row::Raw<TV> sr[CH], br[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = lane + 32 * i;
      if (c < chunks) {
        row::load_raw(xr[i], x + (size_t)r * d + 8 * c);
        row::load_raw(sr[i], scale + 8 * c);
        row::load_raw(br[i], bias + 8 * c);
      }
    }
    float v[CH][8], a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      if (lane + 32 * i < chunks) {
        row::widen(v[i], xr[i]);
#pragma unroll
        for (int k = 0; k < 8; ++k) a[k] += v[i][k];
      }
    }
    const float mu = row::warp_sum(row::pairwise8(a)) / (float)d;
#pragma unroll
    for (int k = 0; k < 8; ++k) a[k] = 0.f;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      if (lane + 32 * i < chunks) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          v[i][k] -= mu;
          a[k] += v[i][k] * v[i][k];
        }
      }
    }
    const float rs = rsqrtf(row::warp_sum(row::pairwise8(a)) / (float)d + eps);
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = lane + 32 * i;
      if (c < chunks) {
        float sc[8], bi[8], y[8];
        row::widen(sc, sr[i]);
        row::widen(bi, br[i]);
#pragma unroll
        for (int k = 0; k < 8; ++k) y[k] = (v[i][k] * rs) * sc[k] + bi[k];
        row::store8(out + (size_t)r * d + 8 * c, y);
      }
    }
  }
}

// The kernel of the other widths: one block per row.

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

// -------------- residual add + LayerNorm, a warp per row --------------
// Forward: HAS_LS: x_new = rnd(x + rnd(rnd(ls) * delta)), else x_new = rnd(x
// + delta), rnd to T (the explicit round-to-nearest intrinsics keep the
// compiler from contracting the multiply and the add into one FMA);
// statistics from the rounded x_new; y = ((x_new - mu) * rs) * scale + bias
// rounded once.
// Backward: dx_new = rs * (gs - mean(gs) - xhat * mean(gs * xhat)) + g_xnew
// in fp32 (gs = g_y * scale), rounded once; with HAS_LS ddelta = dx_new
// (fp32) * ls rounded once; column sums of g_y * xhat, g_y and dx_new *
// delta (dscale, dbias, dls). gy or gxn may be null (a cotangent that does
// not exist reads as zero).
//
// What bounds both: bytes (the forward reads x, delta and writes x_new, y;
// the backward reads x_new, g_y, g_xnew, delta and writes dx_new, ddelta),
// with ~12 and ~24 fp32 operations a value. The first kernels took a block
// of 256 threads a row, three 2-byte loads a thread and two block barriers a
// row (and a block walking 32 rows backward: 514 blocks at the training
// shape, four barriers a row). Here a warp owns a row and holds it as CH
// chunks of eight values a lane (row_vec.cuh): 16-byte loads and stores,
// both pairs of row sums by shuffles, no barrier in the row loop. Warp w of
// the grid walks rows w, w + (warps of the grid), ... The forward keeps
// rnd(ls) in registers and reads scale and bias per row (3 KB each, from
// the L1), ~100 registers: 16 or more warps a multiprocessor keep 48 KB of
// loads in flight (holding the next row's loads as well cost the registers
// at which ptxas spilled); its grid is kernel 6's forward's
// (ops/dino_layer.py::layer_norm_plan). The backward keeps the running
// sums of g_y * xhat and g_y in registers (16 CH a lane, as kernel 6's
// backward); the third running sum, dx_new * delta, lives in a row of shared
// memory a warp that only the lane owning a chunk touches, and scale in
// shared memory a block (a third 8 CH in registers, or scale's, would pass
// 255 a thread). In bf16 every load of a row, delta's too, is requested
// before any of it is used (~200 registers); fp32 chunks, eight registers
// each, load g_xnew and delta where they are used. Its grid is kernel 6's
// backward's (ops/layer_norm.py::layer_norm_bwd_plan: one wave of blocks of
// two warps); at the end a block adds its warps' sums in warp order and
// writes one fp32 partial of each column sum, part[block][sum][d]. Which
// rows a warp takes depends on the shape and the grid alone, so two runs
// add in the same order.

// grid: any number of blocks of 32 * warps threads.
template <typename T, bool HAS_LS, int CH>
__global__ void __launch_bounds__(256) add_ln_fwd_rows_kernel(
    const T* __restrict__ x, const T* __restrict__ delta,
    const float* __restrict__ ls, const float* __restrict__ scale,
    const float* __restrict__ bias, T* __restrict__ xn, T* __restrict__ y,
    int rows, int d, float eps) {
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int stride = gridDim.x * warps;
  const int chunks = d >> 3;
  float lv[CH][8];
  if (HAS_LS) {
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      if (lane + 32 * i < chunks) {
        row::load8(lv[i], ls + 8 * (lane + 32 * i));
#pragma unroll
        for (int k = 0; k < 8; ++k) lv[i][k] = rnd<T>(lv[i][k]);
      }
    }
  }
  for (int r = blockIdx.x * warps + (threadIdx.x >> 5); r < rows;
       r += stride) {
    row::Raw<T> xc[CH], dc[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      if (lane + 32 * i < chunks) {
        const size_t o = (size_t)r * d + 8 * (lane + 32 * i);
        row::load_raw(xc[i], x + o);
        row::load_raw(dc[i], delta + o);
      }
    }
    float v[CH][8];
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      if (lane + 32 * i < chunks) {
        float dv[8];
        row::widen(v[i], xc[i]);
        row::widen(dv, dc[i]);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          float dl = dv[k];
          if (HAS_LS) dl = rnd<T>(__fmul_rn(lv[i][k], dl));
          v[i][k] = rnd<T>(__fadd_rn(v[i][k], dl));
          s += v[i][k];
          s2 += v[i][k] * v[i][k];
        }
        row::store8(xn + (size_t)r * d + 8 * (lane + 32 * i), v[i]);
      }
    }
    row::warp_sum2(s, s2);
    const float mu = s / (float)d;
    const float var = fmaxf(s2 / (float)d - mu * mu, 0.f);
    const float rs = rsqrtf(var + eps);
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      if (lane + 32 * i < chunks) {
        const int c = 8 * (lane + 32 * i);
        float sc[8], bi[8], out[8];
        row::load8(sc, scale + c);
        row::load8(bi, bias + c);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          out[k] = ((v[i][k] - mu) * rs) * sc[k] + bi[k];
        row::store8(y + (size_t)r * d + c, out);
      }
    }
  }
}

// grid: any number of blocks of 32 * warps threads (warps <= 8); with HAS_LS,
// warps * CH KB of dynamic shared memory.
template <typename T, bool HAS_LS, int CH>
__global__ void __launch_bounds__(256) add_ln_bwd_rows_kernel(
    const T* __restrict__ gy, const T* __restrict__ gxn,
    const T* __restrict__ xn, const T* __restrict__ delta,
    const float* __restrict__ ls, const float* __restrict__ scale,
    T* __restrict__ dxn, T* __restrict__ dd, float* __restrict__ part,
    int rows, int d, float eps) {
  constexpr int SUMS = HAS_LS ? 3 : 2;
  // bf16 chunks are four registers: g_xnew and delta are requested with the
  // row's other loads; fp32 rows load them where they are used
  constexpr bool EARLY = sizeof(T) == 2;
  __shared__ float red[2 * 256 * CH];  // the block's sums: g * xhat, then g
  // scale, and the dls sums of warp w, as chunk i of lane l at [i][half][l]
  // (four columns a float4: a warp's accesses are 512 contiguous bytes)
  __shared__ float4 sc[CH * 64];
  extern __shared__ float4 dls[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int stride = gridDim.x * warps;
  const int chunks = d >> 3;
  for (int j = threadIdx.x; j < 2 * chunks; j += blockDim.x)
    sc[((j >> 6) * 2 + (j & 1)) * 32 + ((j >> 1) & 31)] =
        reinterpret_cast<const float4*>(scale)[j];
  float4* mine = dls + warp * CH * 64 + lane;
  float sum_gx[CH][8], sum_g[CH][8];
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    if (HAS_LS && lane + 32 * i < chunks) {
      mine[64 * i] = make_float4(0.f, 0.f, 0.f, 0.f);
      mine[64 * i + 32] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) sum_gx[i][k] = sum_g[i][k] = 0.f;
  }
  __syncthreads();
  for (int r = blockIdx.x * warps + warp; r < rows; r += stride) {
    // the row's loads are requested before any of it is used
    row::Raw<T> xc[CH], gc[CH], hc[CH], dc[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      if (lane + 32 * i < chunks) {
        const size_t o = (size_t)r * d + 8 * (lane + 32 * i);
        row::load_raw(xc[i], xn + o);
        if (gy != nullptr) row::load_raw(gc[i], gy + o);
        if (EARLY && gxn != nullptr) row::load_raw(hc[i], gxn + o);
        if (EARLY && HAS_LS) row::load_raw(dc[i], delta + o);
      }
    }
    float xv[CH][8], gv[CH][8];
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      if (lane + 32 * i < chunks) {
        row::widen(xv[i], xc[i]);
        if (gy != nullptr) {
          row::widen(gv[i], gc[i]);
        } else {
#pragma unroll
          for (int k = 0; k < 8; ++k) gv[i][k] = 0.f;
        }
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
        const float4 lo = sc[64 * i + lane], hi = sc[64 * i + 32 + lane];
        const float scv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float xhat = (xv[i][k] - mu) * rs;
          const float gs = gv[i][k] * scv[k];
          sum_gx[i][k] += gv[i][k] * xhat;
          sum_g[i][k] += gv[i][k];
          a += gs;
          b += gs * xhat;
          xv[i][k] = xhat;
          gv[i][k] = gs;
        }
      }
    }
    row::warp_sum2(a, b);
    const float m1 = a / (float)d, m2 = b / (float)d;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      if (lane + 32 * i < chunks) {
        const int c = 8 * (lane + 32 * i);
        const size_t o = (size_t)r * d + c;
        float v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = rs * (gv[i][k] - m1 - xv[i][k] * m2);
        if (gxn != nullptr) {
          float hv[8];
          if (!EARLY) row::load_raw(hc[i], gxn + o);
          row::widen(hv, hc[i]);
#pragma unroll
          for (int k = 0; k < 8; ++k) v[k] += hv[k];
        }
        row::store8(dxn + o, v);
        if (HAS_LS) {
          float lsv[8], dv[8], out[8];
          row::load8(lsv, ls + c);
          if (!EARLY) row::load_raw(dc[i], delta + o);
          row::widen(dv, dc[i]);
#pragma unroll
          for (int k = 0; k < 8; ++k) out[k] = v[k] * lsv[k];
          row::store8(dd + o, out);
          float4 lo = mine[64 * i], hi = mine[64 * i + 32];
          lo.x += v[0] * dv[0];
          lo.y += v[1] * dv[1];
          lo.z += v[2] * dv[2];
          lo.w += v[3] * dv[3];
          hi.x += v[4] * dv[4];
          hi.y += v[5] * dv[5];
          hi.z += v[6] * dv[6];
          hi.w += v[7] * dv[7];
          mine[64 * i] = lo;
          mine[64 * i + 32] = hi;
        }
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
  float* p = part + (size_t)blockIdx.x * SUMS * d;
  for (int c = threadIdx.x; c < 2 * d; c += blockDim.x) p[c] = red[c];
  if (HAS_LS) {
    const float* sums = reinterpret_cast<const float*>(dls);
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      // column c is value c % 4 of float4 [i][half][l] for chunk 32 i + l
      const int chunk = c >> 3;
      const int at = (((chunk >> 5) * 2 + ((c >> 2) & 1)) * 32 + (chunk & 31))
                     * 4 + (c & 3);
      float s = 0.f;
      for (int w = 0; w < warps; ++w) s += sums[w * CH * 256 + at];
      p[2 * d + c] = s;
    }
  }
}

// ------------- residual add + LayerNorm at the other widths -------------
// The first kernels, for widths the warp-per-row kernels do not take (no
// multiple of 8, wider than 1024, or a tensor off a 16-byte boundary).
// Forward: one block per row.

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

// Backward: one block walks rows [blockIdx.x * rpb, +rpb); part[block][sum]
// [d] as above.

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
// not read again before the next GEMM), and erfc is the Chebyshev fit of
// gelu_fit.cuh: ~20 instructions. Against 0.5 x erfc(-x / sqrt 2) with
// erfcf it is within one bf16 ulp of the value at every finite bf16 input
// (subnormal outputs included: the non-ftz ex2 keeps them) and within 1e-6
// of the output scale in fp32.

constexpr int GELU_THREADS = 256;
constexpr int GELU_VECS = 4;

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
      for (int j = 0; j < VEC; ++j) st(vals + j, gelu_fit::gelu(ld(vals + j)));
      __stcs(reinterpret_cast<uint4*>(out) + i, raw[k]);
    }
  }
  const long long stride = (long long)gridDim.x * GELU_THREADS;
  for (long long i = vectors * VEC + (long long)blockIdx.x * GELU_THREADS +
                     threadIdx.x;
       i < n; i += stride)
    st(out + i, gelu_fit::gelu(ld(x + i)));
}

// ----------------------------- C interface ------------------------------

extern "C" {

// The widest row the row kernels take.
int row_max_width() { return ROW_THREADS * ROW_MAXC; }

// is_f32: x and out fp32, else bf16. vec_f32: scale and bias (d,) fp32,
// else bf16. chunks 0: one block per row (d <= row_max_width()). Else the
// warp-per-row kernel: chunks = the 8-value chunks a lane holds (d % 8 ==
// 0, d <= 256 * chunks <= 1024; every tensor 16-byte aligned), `blocks`
// blocks of `warps` warps.
int row_layer_norm(const void* x, const void* scale, const void* bias,
                   void* out, int rows, int d, float eps, int is_f32,
                   int vec_f32, int chunks, int blocks, int warps,
                   void* stream) {
  if (chunks != 0 && (chunks < 0 || chunks > 4 || d % 8 != 0 ||
                      d > 256 * chunks || warps < 1 || warps > 8 ||
                      blocks < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define LAYER_NORM(T, TV)                                                     \
  do {                                                                        \
    const T* px = (const T*)x;                                                \
    const TV *ps = (const TV*)scale, *pb = (const TV*)bias;                   \
    if (chunks == 0)                                                          \
      layer_norm_two_pass_kernel<T, TV><<<rows, ROW_THREADS, 0, s>>>(         \
          px, ps, pb, (T*)out, d, eps);                                       \
    else if (chunks <= 3)                                                     \
      layer_norm_one_pass_rows_kernel<T, TV, 3>                               \
          <<<blocks, 32 * warps, 0, s>>>(px, ps, pb, (T*)out, rows, d, eps);  \
    else                                                                      \
      layer_norm_one_pass_rows_kernel<T, TV, 4>                               \
          <<<blocks, 32 * warps, 0, s>>>(px, ps, pb, (T*)out, rows, d, eps);  \
  } while (0)
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
// chunks 0: one block per row (d <= row_max_width()). Else the warp-per-row
// kernel: chunks = the 8-value chunks a lane holds (d % 8 == 0, d <= 256 *
// chunks <= 1024; every tensor 16-byte aligned), `blocks` blocks of `warps`
// warps.
int row_add_ln_fwd(const void* x, const void* delta, const void* ls,
                   const void* scale, const void* bias, void* xn, void* y,
                   int rows, int d, float eps, int is_f32, int chunks,
                   int blocks, int warps, void* stream) {
  if (chunks != 0 && (chunks < 0 || chunks > 4 || d % 8 != 0 ||
                      d > 256 * chunks || warps < 1 || warps > 8 ||
                      blocks < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define ADD_LN_FWD(T, HAS_LS)                                                 \
  do {                                                                        \
    const T *px = (const T*)x, *pd = (const T*)delta;                         \
    const float *pl = (const float*)ls, *ps = (const float*)scale,            \
                *pb = (const float*)bias;                                     \
    if (chunks == 0)                                                          \
      add_ln_fwd_kernel<T, HAS_LS><<<rows, ROW_THREADS, 0, s>>>(              \
          px, pd, pl, ps, pb, (T*)xn, (T*)y, d, eps);                         \
    else if (chunks <= 3)                                                     \
      add_ln_fwd_rows_kernel<T, HAS_LS, 3><<<blocks, 32 * warps, 0, s>>>(     \
          px, pd, pl, ps, pb, (T*)xn, (T*)y, rows, d, eps);                   \
    else                                                                      \
      add_ln_fwd_rows_kernel<T, HAS_LS, 4><<<blocks, 32 * warps, 0, s>>>(     \
          px, pd, pl, ps, pb, (T*)xn, (T*)y, rows, d, eps);                   \
  } while (0)
  if (is_f32) {
    if (ls) ADD_LN_FWD(float, true); else ADD_LN_FWD(float, false);
  } else {
    if (ls) ADD_LN_FWD(bf16, true); else ADD_LN_FWD(bf16, false);
  }
#undef ADD_LN_FWD
  return (int)cudaGetLastError();
}

// ls null: no LayerScale (delta, dd unused; part is blocks x 2 x d); else
// part is blocks x 3 x d. gy, gxn may be null. chunks 0: a block of 256
// threads walks rpb rows, blocks = ceil(rows / rpb). Else the warp-per-row
// kernel (as row_add_ln_fwd), `blocks` blocks of `warps` warps.
int row_add_ln_bwd(const void* gy, const void* gxn, const void* xn,
                   const void* delta, const void* ls, const void* scale,
                   void* dxn, void* dd, void* part, int rows, int d, int rpb,
                   float eps, int is_f32, int chunks, int blocks, int warps,
                   void* stream) {
  if (chunks != 0 && (chunks < 0 || chunks > 4 || d % 8 != 0 ||
                      d > 256 * chunks || warps < 1 || warps > 8 ||
                      blocks < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // the warp-per-row backward's dls sums: CH KB a warp
  const size_t smem = ls ? (size_t)warps * (chunks <= 3 ? 3 : 4) * 1024 : 0;
#define ADD_LN_BWD(T, HAS_LS)                                                 \
  do {                                                                        \
    const T *pg = (const T*)gy, *ph = (const T*)gxn, *px = (const T*)xn,      \
            *pd = (const T*)delta;                                            \
    const float *pl = (const float*)ls, *ps = (const float*)scale;            \
    if (chunks == 0)                                                          \
      add_ln_bwd_kernel<T, HAS_LS><<<(rows + rpb - 1) / rpb, ROW_THREADS, 0,  \
                                     s>>>(pg, ph, px, pd, pl, ps, (T*)dxn,    \
                                          (T*)dd, (float*)part, rows, d, rpb, \
                                          eps);                               \
    else if (chunks <= 3)                                                     \
      add_ln_bwd_rows_kernel<T, HAS_LS, 3><<<blocks, 32 * warps, smem, s>>>(  \
          pg, ph, px, pd, pl, ps, (T*)dxn, (T*)dd, (float*)part, rows, d,     \
          eps);                                                               \
    else                                                                      \
      add_ln_bwd_rows_kernel<T, HAS_LS, 4><<<blocks, 32 * warps, smem, s>>>(  \
          pg, ph, px, pd, pl, ps, (T*)dxn, (T*)dd, (float*)part, rows, d,     \
          eps);                                                               \
  } while (0)
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
