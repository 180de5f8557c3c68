// The exact GELU's erfc, shared by row_kernels.cu (kernel 9's GELU forward)
// and layer_backward.cu (the layer backward's GELU pass):
//
//   gelu(x) = 0.5 x erfc(-x / sqrt 2),   cdf(x) = 0.5 erfc(-x / sqrt 2)
//
// erfc is Numerical Recipes' Chebyshev fit `erfcc`, erfc(a) = t exp(-a^2 +
// P(t)) with t = 1 / (1 + a/2) for a >= 0 and 2 - erfc(-a) below
// (fractional error < 1.2e-7 everywhere), on the fast reciprocal and
// `ex2.approx`: ~20 instructions where CUDA's erfcf takes ~45 and 1 + erff
// cancels for negative arguments. The non-ftz `ex2` keeps subnormal results.

#pragma once

#include <cuda_runtime.h>

namespace gelu_fit {

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

// erfc(-x / sqrt 2) = 2 cdf(x)
__device__ __forceinline__ float erfc_neg(float x) {
  const float z = -x * 0.70710678118654752f;
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
  return z < 0.f ? 2.f - e : e;
}

__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * erfc_neg(x);
}

// the standard normal density, exp(-x^2 / 2) / sqrt(2 pi), by one ex2
__device__ __forceinline__ float pdf(float x) {
  return 0.39894228040143268f * fast_exp2(x * x * -0.72134752044448170f);
}

}  // namespace gelu_fit
