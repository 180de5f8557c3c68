// Building blocks of the warp-per-row kernels: a row of a (rows, d) matrix is
// held in the registers of one warp as chunks of eight neighbouring values
// (lane l owns chunks l, l + 32, ...: a warp's 16-byte loads of one chunk
// index cover 512 (bf16) or 1024 (fp32) contiguous bytes), a row's sums are
// warp shuffles, and nothing of a row passes through shared memory. Included
// by dino_layer.cu (the LayerNorm forward) and layer_backward.cu (the
// LayerNorm backward). Everything is inline and lives in namespace `row`.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace row {

// The eight values of a chunk as they lie in memory: one 16-byte register
// group of bf16, two of fp32. A load into Raw starts the memory request; the
// values are widened when they are used, so the chunks of the next row can
// be in flight while this row is computed.
template <typename T>
struct Raw;
template <>
struct Raw<bf16> {
  uint4 v;
};
template <>
struct Raw<float> {
  float4 lo, hi;
};

__device__ __forceinline__ void load_raw(Raw<bf16>& r, const bf16* p) {
  r.v = *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void load_raw(Raw<float>& r, const float* p) {
  r.lo = reinterpret_cast<const float4*>(p)[0];
  r.hi = reinterpret_cast<const float4*>(p)[1];
}

__device__ __forceinline__ void widen(float (&y)[8], const Raw<bf16>& r) {
  const uint32_t w[4] = {r.v.x, r.v.y, r.v.z, r.v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    y[2 * i] = __low2float(p);
    y[2 * i + 1] = __high2float(p);
  }
}
__device__ __forceinline__ void widen(float (&y)[8], const Raw<float>& r) {
  y[0] = r.lo.x, y[1] = r.lo.y, y[2] = r.lo.z, y[3] = r.lo.w;
  y[4] = r.hi.x, y[5] = r.hi.y, y[6] = r.hi.z, y[7] = r.hi.w;
}

template <typename T>
__device__ __forceinline__ void load8(float (&y)[8], const T* p) {
  Raw<T> r;
  load_raw(r, p);
  widen(y, r);
}

// Eight values rounded once to the output's type, one 16-byte store (two
// for fp32).
__device__ __forceinline__ void store8(bf16* p, const float (&y)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&v);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void store8(float* p, const float (&y)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(y[0], y[1], y[2], y[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(y[4], y[5], y[6], y[7]);
}

// Eight values added pairwise: ((a0 + a1) + (a2 + a3)) + ((a4 + a5) + (a6 +
// a7)), three adds deep.
__device__ __forceinline__ float pairwise8(const float (&a)[8]) {
  return ((a[0] + a[1]) + (a[2] + a[3])) + ((a[4] + a[5]) + (a[6] + a[7]));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
// Two sums at once: their shuffles interleave, so the pair costs the
// latency of one.
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

}  // namespace row
