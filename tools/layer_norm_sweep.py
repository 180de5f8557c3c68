#!/usr/bin/env python3
"""Measures the design of kernel 5, the one-pass serving LayerNorm
(hypervla_tpu_torch/csrc/row_kernels.cu::layer_norm_one_pass_rows_kernel, a
warp per row), at the serving shape (257 rows of 768, bf16, bf16 scale and
bias) on one NVIDIA GPU:

1. In one profiler trace, each kernel's device time: the port's kernel (a
   warp per row on ops/layer_norm.py::layer_norm_plan), its first version
   (layer_norm_two_pass_kernel, which rows off a 16-byte boundary take),
   the variant that splits a row over a block of ceil(d / 256) warps with
   one 16-byte chunk a lane (built here from the source below; the two
   sums of each warp, its sum and its centred sum of squares, meet at one
   barrier and are combined as Chan et al.'s pairwise update), kernel 6's
   forward (ops/dino_layer.py::layer_norm_rows, fp32 vectors) and
   F.layer_norm. Three traces.
2. The port's kernel on other grids at that shape (blocks of 1, 2, 4 and 8
   warps), one trace each, in turns there and back.

Each variant is first held to the plain version
(ops/layer_norm.py::layer_norm_reference): one bf16 ulp of the output
scale, rows shifted by 0 and by +100.

    python3 tools/layer_norm_sweep.py

Prints one JSON line per measurement. Needs a CUDA device and nvcc.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SOURCE = r"""
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "row_vec.cuh"

// A block of ceil(d / 256) warps a row, one chunk of eight values a lane.
// Each warp adds its values (a lane's eight pairwise, as the port's kernel
// adds its running sums), takes its own mean and the sum of squares about
// it; the warps' pairs meet at one barrier and every thread combines
// them in warp order: mean = S / d, M2 = sum_w (q_w + n_w (m_w - mean)^2).
template <typename T, typename TV>
__global__ void __launch_bounds__(128) layer_norm_split_kernel(
    const T* __restrict__ x, const TV* __restrict__ scale,
    const TV* __restrict__ bias, T* __restrict__ out, int d, float eps) {
  __shared__ float red[2][4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5, chunks = d >> 3;
  const int c = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * d;
  row::Raw<T> xr;
  row::Raw<TV> sr, br;
  if (c < chunks) {
    row::load_raw(xr, x + base + 8 * c);
    row::load_raw(sr, scale + 8 * c);
    row::load_raw(br, bias + 8 * c);
  }
  float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (c < chunks) row::widen(v, xr);
  const float s = row::warp_sum(row::pairwise8(v));
  const float n_w = 8.f * (float)min(32, chunks - 32 * warp);
  const float m_w = s / n_w;
  float t[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) t[k] = c < chunks ? (v[k] - m_w) * (v[k] - m_w)
                                                : 0.f;
  const float q = row::warp_sum(row::pairwise8(t));
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = q;
  }
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < warps; ++w) total += red[0][w];
  const float mu = total / (float)d;
  float m2 = 0.f;
  for (int w = 0; w < warps; ++w) {
    const float n = 8.f * (float)min(32, chunks - 32 * w);
    const float dm = red[0][w] / n - mu;
    m2 += red[1][w] + n * dm * dm;
  }
  const float rs = rsqrtf(m2 / (float)d + eps);
  if (c < chunks) {
    float sc[8], bi[8], y[8];
    row::widen(sc, sr);
    row::widen(bi, br);
#pragma unroll
    for (int k = 0; k < 8; ++k) y[k] = ((v[k] - mu) * rs) * sc[k] + bi[k];
    row::store8(out + base + 8 * c, y);
  }
}

extern "C" {
// x, out bf16; scale, bias bf16; d % 8 == 0, d <= 1024, 16-byte aligned.
int layer_norm_split_bf16(const void* x, const void* scale, const void* bias,
                          void* out, int rows, int d, float eps, void* s) {
  if (d % 8 || d > 1024) return (int)cudaErrorInvalidValue;
  const int warps = (d / 8 + 31) / 32;
  layer_norm_split_kernel<__nv_bfloat16, __nv_bfloat16>
      <<<rows, 32 * warps, 0, (cudaStream_t)s>>>(
          (const __nv_bfloat16*)x, (const __nv_bfloat16*)scale,
          (const __nv_bfloat16*)bias, (__nv_bfloat16*)out, d, eps);
  return (int)cudaGetLastError();
}
}
"""


def build():
    from hypervla_tpu_torch.utils import cuda_build

    out_dir = ROOT / "build" / "tools"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "layer_norm_split.cu", out_dir / "layer_norm_split.so"
    src.write_text(SOURCE)
    subprocess.run([cuda_build._find_nvcc(), *cuda_build.NVCC_FLAGS,
                    "-Xptxas", "-v", "-I",
                    str(ROOT / "hypervla_tpu_torch" / "csrc"), "-o", str(lib),
                    str(src)], check=True)
    lib = ctypes.CDLL(str(lib))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.layer_norm_split_bf16.argtypes = [p, p, p, p, i, i, f, p]
    lib.layer_norm_split_bf16.restype = ctypes.c_int
    return lib


def main():
    import numpy as np
    import torch
    import torch.nn.functional as F

    from chip_smoke import PROFILED_CALLS, bound_ms, kernel_device_ms, nbytes
    from hypervla_tpu_torch.ops import dino_layer as dl
    from hypervla_tpu_torch.ops import layer_norm as tln

    if not torch.cuda.is_available():
        print("layer_norm_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    device = torch.device("cuda", 0)
    lib = build()
    rows, d, eps = 257, 768, 1e-6
    rng = np.random.default_rng(0)

    def t(shape, scale=1.0, shift=0.0, dtype=torch.bfloat16):
        return torch.tensor((rng.standard_normal(shape) * scale
                             + shift).astype(np.float32), device=device
                            ).to(dtype)

    sc, bi = t((d,), 0.1, 1.0), t((d,), 0.1)

    def split(x):
        out = torch.empty_like(x)
        code = lib.layer_norm_split_bf16(x.data_ptr(), sc.data_ptr(),
                                         bi.data_ptr(), out.data_ptr(),
                                         x.shape[0], d, eps, dl._stream())
        assert code == 0, code
        return out

    def plan_run(x, plan):
        out = torch.empty_like(x)
        code = tln.row_lib().row_layer_norm(
            x.data_ptr(), sc.data_ptr(), bi.data_ptr(), out.data_ptr(), rows,
            d, eps, 0, 0, *plan, dl._stream())
        assert code == 0, code
        return out

    grids = [dl.RowPlan(3, -(-rows // w), w) for w in (1, 2, 4, 8)]
    for shift in (0.0, 100.0):
        x = t((rows, d), 2.0, shift)
        ref = tln.layer_norm_reference(x, sc, bi, eps).float()
        bound = 2 ** -7 * max(float(ref.abs().max()), 1.0)
        outs = {"split": split(x), "port": tln.layer_norm(x, sc, bi, eps)}
        outs.update({f"grid {tuple(p)}": plan_run(x, p) for p in grids})
        torch.cuda.synchronize()
        for name, out in outs.items():
            err = float((out.float() - ref).abs().max())
            assert err <= bound, (name, shift, err, bound)
            print(json.dumps({"layer_norm_check": {
                "variant": name, "shift": shift, "max_abs_err": err,
                "bound": bound}}), flush=True)

    x = t((1, rows, d), 0.5, 0.3)
    x2 = x.view(rows, d)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=device)
    x_odd = flat[1:].view(x.shape).copy_(x)
    sc32, bi32 = sc.float(), bi.float()

    def all_five():
        tln.layer_norm(x, sc, bi, eps)
        split(x2)
        tln.layer_norm(x_odd, sc, bi, eps)
        dl.layer_norm_rows(x2, sc32, bi32, eps)
        F.layer_norm(x, (d,), sc, bi, eps)

    kinds = {"layer_norm_one_pass_rows_kernel": "port: a warp per row",
             "layer_norm_split_kernel": "split: a block of 3 warps a row",
             "layer_norm_two_pass_kernel": "first version",
             "layer_norm_rows_kernel": "kernel 6 layer_norm_rows"}
    least, by = bound_ms(nbytes(x, x, sc, bi), 8 * x.numel(), 67e12)
    for trace in range(3):
        line = {}
        for name, ms in kernel_device_ms(all_five, PROFILED_CALLS).items():
            kind = kinds.get(name.split("<")[0], "F.layer_norm")
            line[kind] = line.get(kind, 0.0) + ms
        print(json.dumps({"layer_norm_one_trace": {
            "trace": trace, "device_ms": line, "bound_ms": least,
            "bound_by": by}}), flush=True)

    times = {tuple(p): [] for p in grids}
    for p in grids + grids[::-1]:
        times[tuple(p)].append(sum(kernel_device_ms(
            lambda: plan_run(x2, p), PROFILED_CALLS).values()))
    for p, runs in times.items():
        print(json.dumps({"layer_norm_grid": {
            "plan": p, "chosen": p == tuple(tln.layer_norm_plan(rows, d)),
            "device_ms": sum(runs) / len(runs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
