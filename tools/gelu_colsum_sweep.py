#!/usr/bin/env python3
"""Measures the design choices behind three kernels of the PyTorch/CUDA port
on one NVIDIA GPU, at the training shapes (batch 64, 257 tokens, width 768):

1. The exact GELU's erfc form (hypervla_tpu_torch/csrc/gelu_fit.cuh, kernel
   9's row_kernels.cu::gelu_kernel). The same kernel (GELU_VECS 16-byte
   vectors a thread, one pass of blocks, streaming loads and stores) is
   built here with each form of 0.5 x erfc(-x / sqrt 2):
     erfcf           CUDA's erfcf
     erfc_fit        Numerical Recipes' erfcc Chebyshev fit on the fast
                     reciprocal and ex2.approx (gelu_fit.cuh: the form the
                     port ships)
     erff_split      0.5 x (1 + erff(t)) for t = x / sqrt 2 >= -0.5, where
                     nothing cancels, CUDA's erfcf below
     tpu_polynomial  the TPU kernel's rational polynomial erf
                     (hypervla_tpu/ops/gelu.py) with a fast reciprocal
   and erfc_fit also with 1 and 2 vectors a thread. Each is timed at
   (64, 257, 3072) bf16 beside F.gelu, and held elementwise to the plain
   version (ops/gelu.py::gelu_exact_reference) at every finite bf16 input
   (bf16 ulps of the plain value) and on fp32 draws (error over the output
   scale).
2. The GELU backward pass's arithmetic (csrc/layer_backward.cu::
   gelu_bwd_kernel) at (16448, 3072): the port's layout (the column sum's
   16-byte rows and grid, colsum_config) built here with the first kernel's
   erff and expf and with the erfc fit and one more ex2 (the form the port
   ships), timed in turns beside the port's launch, each held to the plain
   version (ops/dino_layer_train.py::gelu_bwd_reference).
3. The column sum's grid (csrc/layer_backward.cu::colsum_kernel) at
   (16448, 2304): the pass and its finishing launch for several part
   counts and warps a block, through the port's own library.

    python3 tools/gelu_colsum_sweep.py

Times are the kernels' device time from torch.profiler traces
(chip_smoke.py::kernel_device_ms: CUDA events around back-to-back calls of
a kernel of a few tens of microseconds read the host's launch rate), the
variants in turns, there and back; SASS instructions of each built kernel
from cuobjdump. Prints one JSON line per measurement. Needs a CUDA device
and nvcc.
"""
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

FORMS = {"erfcf": 0, "erfc_fit": 1, "erff_split": 2, "tpu_polynomial": 3}

SOURCE = r"""
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "gelu_fit.cuh"

using gelu_fit::fast_rcp;

template <int FORM>
__device__ __forceinline__ float gelu(float x) {
  if (FORM == 0) return 0.5f * x * erfcf(-x * 0.70710678118654752f);
  if (FORM == 1) return gelu_fit::gelu(x);
  if (FORM == 2) {
    const float t = x * 0.70710678118654752f;
    return t >= -0.5f ? 0.5f * x * (1.f + erff(t)) : 0.5f * x * erfcf(-t);
  }
  const float t = fminf(fmaxf(x * 0.70710678118654752f, -4.f), 4.f);
  const float t2 = t * t;
  float p = -2.72614225801306e-10f;
  p = fmaf(p, t2, 2.77068142495902e-08f);
  p = fmaf(p, t2, -2.10102402082508e-06f);
  p = fmaf(p, t2, -5.69250639462346e-05f);
  p = fmaf(p, t2, -7.34990630326855e-04f);
  p = fmaf(p, t2, -2.95459980854025e-03f);
  p = fmaf(p, t2, -1.60960333262415e-02f);
  float q = -1.45660718464996e-05f;
  q = fmaf(q, t2, -2.13374055278905e-04f);
  q = fmaf(q, t2, -1.68282697438203e-03f);
  q = fmaf(q, t2, -7.37332916720468e-03f);
  q = fmaf(q, t2, -1.42647390514189e-02f);
  return x * (0.5f * (1.f + t * p * fast_rcp(q)));
}

// bf16 only, n % 8 == 0, 16-byte aligned
template <int FORM, int VECS>
__global__ void __launch_bounds__(256) gelu_form(
    const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
    long long vectors) {
  const long long first = (long long)blockIdx.x * 256 * VECS + threadIdx.x;
  uint4 raw[VECS];
#pragma unroll
  for (int k = 0; k < VECS; ++k) {
    const long long i = first + k * 256;
    if (i < vectors) raw[k] = __ldcs(reinterpret_cast<const uint4*>(x) + i);
  }
#pragma unroll
  for (int k = 0; k < VECS; ++k) {
    const long long i = first + k * 256;
    if (i < vectors) {
      __nv_bfloat16* v = reinterpret_cast<__nv_bfloat16*>(&raw[k]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = __float2bfloat16_rn(gelu<FORM>(__bfloat162float(v[j])));
      __stcs(reinterpret_cast<uint4*>(out) + i, raw[k]);
    }
  }
}

// fp32 elementwise, one a thread
template <int FORM>
__global__ void gelu_form_f32(const float* x, float* out, long long n) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i < n) out[i] = gelu<FORM>(x[i]);
}

template <int FORM, int VECS>
static int launch(const void* x, void* out, long long n, void* s) {
  const long long vectors = n / 8, per = 256LL * VECS;
  gelu_form<FORM, VECS><<<(unsigned)((vectors + per - 1) / per), 256, 0,
                          (cudaStream_t)s>>>((const __nv_bfloat16*)x,
                                             (__nv_bfloat16*)out, vectors);
  return (int)cudaGetLastError();
}

// The GELU backward pass on the column sum's layout (layer_backward.cu::
// gelu_bwd_kernel), FORM 0: the first kernel's erff and expf; 1: the erfc
// fit and one more ex2 (the port's). grid (ceil(cols / 256), parts), 8 warps.
template <int FORM>
__global__ void __launch_bounds__(256, 4) gelu_bwd_form(
    const __nv_bfloat16* __restrict__ hc, const __nv_bfloat16* __restrict__ dh,
    __nv_bfloat16* __restrict__ h, __nv_bfloat16* __restrict__ dhc,
    float* __restrict__ part, int rows, int cols) {
  __shared__ float4 red[8][64];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = blockIdx.y, parts = gridDim.y;
  const int r0 = (int)((long long)p * rows / parts);
  const int r1 = (int)((long long)(p + 1) * rows / parts);
  const int c0 = blockIdx.x * 256 + 8 * lane;
  float sum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (c0 < cols) {
    for (int r = r0 + warp; r < r1; r += 2 * 8) {
      uint4 xr[2], gr[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (r + k * 8 < r1) {
          const size_t o = (size_t)(r + k * 8) * cols + c0;
          xr[k] = __ldcs(reinterpret_cast<const uint4*>(hc + o));
          gr[k] = __ldcs(reinterpret_cast<const uint4*>(dh + o));
        }
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (r + k * 8 < r1) {
          __nv_bfloat16* xv = reinterpret_cast<__nv_bfloat16*>(&xr[k]);
          __nv_bfloat16* gv = reinterpret_cast<__nv_bfloat16*>(&gr[k]);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float x = __bfloat162float(xv[j]);
            float hx, dg;
            if (FORM == 0) {
              const float cdf = 0.5f * (1.f + erff(x * 0.70710678118654752f));
              const float pdf = expf(-0.5f * x * x) * 0.3989422804014327f;
              hx = x * cdf;
              dg = cdf + x * pdf;
            } else {
              const float e = gelu_fit::erfc_neg(x);
              hx = 0.5f * x * e;
              dg = 0.5f * e + x * gelu_fit::pdf(x);
            }
            const float d = __bfloat162float(__float2bfloat16_rn(
                __bfloat162float(__float2bfloat16_rn(dg))
                * __bfloat162float(gv[j])));
            xv[j] = __float2bfloat16_rn(hx);
            gv[j] = __float2bfloat16_rn(d);
            sum[j] += d;
          }
          const size_t o = (size_t)(r + k * 8) * cols + c0;
          __stcs(reinterpret_cast<uint4*>(h + o), xr[k]);
          __stcs(reinterpret_cast<uint4*>(dhc + o), gr[k]);
        }
      }
    }
  }
  red[warp][2 * lane] = make_float4(sum[0], sum[1], sum[2], sum[3]);
  red[warp][2 * lane + 1] = make_float4(sum[4], sum[5], sum[6], sum[7]);
  __syncthreads();
  const float* sums = reinterpret_cast<const float*>(red);
  const int col = blockIdx.x * 256 + threadIdx.x;
  if (col < cols) {
    float s = sums[threadIdx.x];
    for (int w = 1; w < 8; ++w) s += sums[w * 256 + threadIdx.x];
    part[(size_t)p * cols + col] = s;
  }
}

extern "C" {
// cols % 8 == 0; part is parts x cols fp32
int gelu_bwd_bf16(const void* hc, const void* dh, void* h, void* dhc,
                  void* part, int rows, int cols, int parts, int form,
                  void* s) {
  const dim3 grid((cols + 255) / 256, parts);
  if (cols % 8) return (int)cudaErrorInvalidValue;
  if (form == 0)
    gelu_bwd_form<0><<<grid, 256, 0, (cudaStream_t)s>>>(
        (const __nv_bfloat16*)hc, (const __nv_bfloat16*)dh,
        (__nv_bfloat16*)h, (__nv_bfloat16*)dhc, (float*)part, rows, cols);
  else
    gelu_bwd_form<1><<<grid, 256, 0, (cudaStream_t)s>>>(
        (const __nv_bfloat16*)hc, (const __nv_bfloat16*)dh,
        (__nv_bfloat16*)h, (__nv_bfloat16*)dhc, (float*)part, rows, cols);
  return (int)cudaGetLastError();
}

int gelu_form_bf16(const void* x, void* out, long long n, int form,
                   int vecs, void* s) {
  if (n % 8) return (int)cudaErrorInvalidValue;
  if (vecs == 4) {
    switch (form) {
      case 0: return launch<0, 4>(x, out, n, s);
      case 1: return launch<1, 4>(x, out, n, s);
      case 2: return launch<2, 4>(x, out, n, s);
      case 3: return launch<3, 4>(x, out, n, s);
    }
  }
  if (form == 1 && vecs == 2) return launch<1, 2>(x, out, n, s);
  if (form == 1 && vecs == 1) return launch<1, 1>(x, out, n, s);
  return (int)cudaErrorInvalidValue;
}

int gelu_form_fp32(const void* x, void* out, long long n, int form,
                   void* s) {
  const unsigned blocks = (unsigned)((n + 255) / 256);
  cudaStream_t st = (cudaStream_t)s;
  const float* xf = (const float*)x;
  float* of = (float*)out;
  switch (form) {
    case 0: gelu_form_f32<0><<<blocks, 256, 0, st>>>(xf, of, n); break;
    case 1: gelu_form_f32<1><<<blocks, 256, 0, st>>>(xf, of, n); break;
    case 2: gelu_form_f32<2><<<blocks, 256, 0, st>>>(xf, of, n); break;
    default: gelu_form_f32<3><<<blocks, 256, 0, st>>>(xf, of, n);
  }
  return (int)cudaGetLastError();
}
}
"""


def build():
    from hypervla_tpu_torch.utils import cuda_build

    out_dir = ROOT / "build" / "tools"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "gelu_forms.cu", out_dir / "gelu_forms.so"
    src.write_text(SOURCE)
    nvcc = cuda_build._find_nvcc()
    subprocess.run([nvcc, *cuda_build.NVCC_FLAGS, "-I",
                    str(ROOT / "hypervla_tpu_torch" / "csrc"), "-o", str(lib),
                    str(src)], check=True)
    sass_counts(Path(nvcc).parent / "cuobjdump", lib)
    lib = ctypes.CDLL(str(lib))
    p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gelu_form_bf16.argtypes = [p, p, n, i, i, p]
    lib.gelu_form_fp32.argtypes = [p, p, n, i, p]
    lib.gelu_bwd_bf16.argtypes = [p, p, p, p, p, i, i, i, i, p]
    for fn in (lib.gelu_form_bf16, lib.gelu_form_fp32, lib.gelu_bwd_bf16):
        fn.restype = ctypes.c_int
    return lib


def sass_counts(cuobjdump, lib):
    """Prints the SASS instructions of each kernel built here."""
    out = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = 0
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            counts[name] += 1
    print(json.dumps({"sass_instructions": counts}), flush=True)


def device_ms(fn):
    """{device kernel: ms per call of fn}."""
    from chip_smoke import PROFILED_CALLS, kernel_device_ms

    return kernel_device_ms(fn, PROFILED_CALLS)


def gelu_forms(lib, device):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from chip_smoke import bf16_ulps
    from hypervla_tpu_torch.ops import gelu as tg

    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(0)
    h = torch.tensor((rng.standard_normal((64, 257, 3072)) * 1.5).astype(
        np.float32), device=device).bfloat16()
    every = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32,
                         device=device).to(torch.int16).view(torch.bfloat16)
    every = every[torch.isfinite(every.float())]
    every = every[:every.numel() // 8 * 8].contiguous()
    x32 = torch.tensor((rng.standard_normal((257, 3072)) * 3.0).astype(
        np.float32), device=device)

    def run(x, form, vecs):
        out = torch.empty_like(x)
        code = lib.gelu_form_bf16(x.data_ptr(), out.data_ptr(), x.numel(),
                                  form, vecs, stream)
        assert code == 0, code
        return out

    variants = [(name, form, 4) for name, form in FORMS.items()]
    variants += [("erfc_fit", FORMS["erfc_fit"], 2),
                 ("erfc_fit", FORMS["erfc_fit"], 1)]
    results = {}
    for name, form, vecs in variants:
        ref = tg.gelu_exact_reference(every)
        got = run(every, form, vecs)
        ulps = bf16_ulps(got, ref)
        out32 = torch.empty_like(x32)
        assert lib.gelu_form_fp32(x32.data_ptr(), out32.data_ptr(),
                                  x32.numel(), form, stream) == 0
        ref32 = tg.gelu_exact_reference(x32)
        err32 = float((out32 - ref32).abs().max()) / max(
            float(ref32.abs().max()), 1.0)
        results[(name, vecs)] = {
            "form": name, "vectors_a_thread": vecs,
            "max_ulps_every_bf16": float(ulps.max()),
            "inputs_over_one_ulp": int((ulps > 1).sum()),
            "worst_input": float(every[int(ulps.argmax())]),
            "fp32_err_over_scale": err32}
    # timed in turns: every variant, then F.gelu and the port's kernel, and
    # back in reverse order
    order = list(results) + ["F.gelu", "port"]
    fns = {key: (lambda form=FORMS[key[0]], vecs=key[1]: run(h, form, vecs))
           for key in results}
    fns["F.gelu"] = lambda: F.gelu(h)
    fns["port"] = lambda: tg.gelu_exact_fused(h)
    times = {key: [] for key in order}
    for key in order + order[::-1]:
        times[key].append(sum(device_ms(fns[key]).values()))
    for key, r in results.items():
        r["device_ms"] = sum(times[key]) / len(times[key])
        print(json.dumps({"gelu_form": r}), flush=True)
    print(json.dumps({"gelu_library": {
        "F.gelu_device_ms": sum(times["F.gelu"]) / 2,
        "port_gelu_exact_fused_device_ms": sum(times["port"]) / 2,
        "bound_ms": 2 * h.numel() * 2 / 3.35e12 * 1e3}}), flush=True)


def gelu_bwd_forms(lib, device):
    import numpy as np
    import torch

    from hypervla_tpu_torch.ops import dino_layer as dl
    from hypervla_tpu_torch.ops import dino_layer_train as dlt
    from hypervla_tpu_torch.ops import layer_norm as ln

    rows, cols = 64 * 257, 3072
    rng = np.random.default_rng(2)
    hc, dh = (torch.tensor((rng.standard_normal((rows, cols)) * s).astype(
        np.float32), device=device).bfloat16() for s in (1.5, 0.1))
    config = dlt.colsum_config(rows, cols)
    ref = dlt.gelu_bwd_reference(hc, dh)

    def run(form):
        h, dhc = torch.empty_like(hc), torch.empty_like(hc)
        part = torch.empty((config.parts, cols), dtype=torch.float32,
                           device=device)
        code = lib.gelu_bwd_bf16(hc.data_ptr(), dh.data_ptr(), h.data_ptr(),
                                 dhc.data_ptr(), part.data_ptr(), rows, cols,
                                 config.parts, form, dl._stream())
        assert code == 0, code
        return h, dhc, ln.finish_sums(part)

    fns = {"erff_expf": lambda: run(0), "erfc_fit": lambda: run(1),
           "port": lambda: dlt.gelu_bwd(hc, dh)}
    errs = {}
    for key, fn in fns.items():
        got = fn()
        errs[key] = [float((a.float() - b.float()).abs().max())
                     / max(float(b.float().abs().max()), 1.0)
                     for a, b in zip(got, ref)]
    order = list(fns)
    times = {key: [] for key in order}
    for key in order + order[::-1]:
        times[key].append(device_ms(fns[key]))
    for key, runs in times.items():
        split = {k: sum(r[k] for r in runs) / len(runs) for k in runs[0]}
        print(json.dumps({"gelu_bwd_form": {
            "form": key, "device_ms": split, "total_ms": sum(split.values()),
            "err_over_scale_h_dhc_db1": errs[key],
            "grid": list(config),
            "bound_ms": (4 * hc.numel() * 2 + cols * 4) / 3.35e12 * 1e3}}),
            flush=True)


def colsum_grids(device):
    import numpy as np
    import torch

    from hypervla_tpu_torch.ops import dino_layer as dl
    from hypervla_tpu_torch.ops import dino_layer_train as dlt
    from hypervla_tpu_torch.ops import layer_norm as ln

    rows, cols = 64 * 257, 2304
    rng = np.random.default_rng(1)
    a = torch.tensor((rng.standard_normal((rows, cols)) * 0.1).astype(
        np.float32), device=device).bfloat16()
    exact = a.double().sum(0)

    def run(parts, warps):
        part = torch.empty((parts, cols), dtype=torch.float32, device=device)
        code = ln._lib().layer_colsum(a.data_ptr(), part.data_ptr(), rows,
                                      cols, parts, warps, dl._stream())
        assert code == 0, code
        return ln.finish_sums(part)

    chosen = dlt.colsum_config(rows, cols)
    grids = [(parts, warps) for warps in (4, 8)
             for parts in (15, 29, 58, 116, 232)]
    times = {g: [] for g in grids}
    for g in grids + grids[::-1]:
        err = float((run(*g).double() - exact).abs().max())
        assert err <= 1e-4 * max(float(exact.abs().max()), 1.0), (g, err)
        times[g].append(device_ms(lambda: run(*g)))
    lib_ms = sum(device_ms(lambda: a.sum(0, dtype=torch.float32)).values())
    for (parts, warps), runs in times.items():
        split = {k: sum(r[k] for r in runs) / len(runs) for k in runs[0]}
        print(json.dumps({"colsum_grid": {
            "parts": parts, "warps": warps, "strips": chosen.strips,
            "chosen": (parts, warps) == (chosen.parts, chosen.warps),
            "device_ms": split, "total_ms": sum(split.values()),
            "sum0_device_ms": lib_ms,
            "bound_ms": (a.numel() * 2 + cols * 4) / 3.35e12 * 1e3}}),
            flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        print("gelu_colsum_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    device = torch.device("cuda", 0)
    lib = build()
    gelu_forms(lib, device)
    gelu_bwd_forms(lib, device)
    colsum_grids(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
