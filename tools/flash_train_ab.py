"""Times the differentiable flash attention's bf16 kernels
(hypervla_tpu_torch/csrc/flash_attention_train.cu through
ops/flash_attention_train.py) at the flagship's training shape (64, 257,
12, 64) and at the serving shape (1, 257, 12, 64), beside
scaled_dot_product_attention's forward and backward and the bound of each,
and, with --first-version PATH (that source as an earlier commit had it,
with the plain C interface it had then: no launch plan), beside that
version built into build/tools/, in turns in one process (first, new,
new, first). Each call's time twice: by CUDA events (the mean over
--iters calls after a warm-up, the wrappers' host work included) and its
kernels' device time from torch.profiler traces (chip_smoke.py's
kernel_device_ms, kernel by kernel); the outputs of the two versions are
held to one bf16 ulp of their scale. With --variant NAME=PATH (repeated)
a patched copy of the current source (its C interface and shared-memory
layout unchanged, e.g. another `Occupancy`) is also built into
build/tools/, its registers and spills printed from `-Xptxas -v`, and
timed at the training shape through the wrappers. Prints the card and one
JSON line.

Run on the card:
    python3 tools/flash_train_ab.py [--first-version PATH] [--iters N]
        [--variant NAME=PATH ...]
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from hypervla_tpu_torch.ops import flash_attention_train as ft  # noqa: E402
from hypervla_tpu_torch.utils.cuda_build import (  # noqa: E402
    NVCC_FLAGS,
    _find_nvcc,
)

SOURCE = ROOT / "hypervla_tpu_torch" / "csrc" / "flash_attention_train.cu"
TOOLS = ROOT / "build" / "tools"
TRAIN_SHAPE = (64, 257, 12, 64)

PEAK_BF16, PEAK_BYTES = 989e12, 3.35e12


def nvcc(source, name):
    """Builds source with the package's flags into build/tools/<name>.so;
    returns (its path, ptxas's report)."""
    out = TOOLS / f"{name}.so"
    TOOLS.mkdir(parents=True, exist_ok=True)
    cmd = [_find_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-I",
           str(SOURCE.parent), "-o", str(out), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    return out, proc.stdout + proc.stderr


def registers(report):
    """{kernel: 'N registers, S bytes spilled'} of the bf16 kernels."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '_Z\d+(\w+?tc_kernel)"
                      r"ILi(\d+)", line)
        if m:
            name = f"{m.group(1)}<{m.group(2)}>"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out[name] = f"{m.group(1)} bytes spilled"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = f"{m.group(1)} registers, {out.get(name, '')}"
            name = None
    return out


def first_library(path):
    """The earlier source as a ctypes library with its own signatures."""
    out, _ = nvcc(path, "flash_attention_train_first")
    lib = ctypes.CDLL(str(out))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mha_flash_trainable_fwd.argtypes = [p] * 6 + [i] * 4 + [f, i, i, i,
                                                                p]
    lib.mha_flash_trainable_bwd.argtypes = [p] * 10 + [i] * 4 + [f, i, i, i,
                                                                 p]
    return lib


def first_calls(lib, q, k, v, g):
    """(forward, backward) closures of the earlier version on these
    inputs; the backward takes the forward's m, n."""
    batch, seq, heads, d = q.shape
    scale = ft.softmax_scale(d)
    nt = ft.q_terms(scale)
    o, dq, dk, dv = (torch.empty_like(q) for _ in range(4))
    m = torch.empty((batch, heads, seq), dtype=torch.float32, device=q.device)
    n, r = torch.empty_like(m), torch.empty_like(m)
    stream = torch.cuda.current_stream().cuda_stream

    def fwd():
        code = lib.mha_flash_trainable_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            m.data_ptr(), n.data_ptr(), batch, heads, seq, d, scale, 0, nt,
            1, stream)
        assert code == 0, code
        return o, m, n

    def bwd():
        code = lib.mha_flash_trainable_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            m.data_ptr(), n.data_ptr(), r.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), batch, heads, seq, d, scale, 0, nt,
            1, stream)
        assert code == 0, code
        return dq, dk, dv

    return fwd, bwd


def cuda_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, calls=20):
    """{kernel: device ms per call} from torch.profiler traces."""
    return {k: round(v, 6) for k, v in
            chip_smoke.kernel_device_ms(fn, calls).items()}


def bound_ms(nbytes, flops):
    return max(nbytes / PEAK_BYTES, flops / PEAK_BF16) * 1e3


def close(got, ref, what):
    got, ref = got.float(), ref.float()
    err = (got - ref).abs().max().item()
    limit = 2 ** -7 * max(ref.abs().max().item(), 1.0)
    if not err <= limit:
        raise AssertionError(f"{what}: {err} > {limit}")
    return err


def case(shape, iters, first, rng):
    q, k, v, g = (torch.tensor(rng.standard_normal(shape).astype(np.float32),
                               dtype=torch.bfloat16, device="cuda")
                  for _ in range(4))
    batch, seq, heads, d = shape
    o, m, n = ft.mha_flash_trainable_fwd(q, k, v)
    grads = ft.mha_flash_trainable_bwd(q, k, v, g, m, n)
    new = (lambda: ft.mha_flash_trainable_fwd(q, k, v),
           lambda: ft.mha_flash_trainable_bwd(q, k, v, g, m, n))
    qt, kt, vt, gt = (a.transpose(1, 2) for a in (q, k, v, g))
    leaves = [a.detach().requires_grad_(True) for a in (qt, kt, vt)]
    out = F.scaled_dot_product_attention(*leaves)
    sdpa = (lambda: F.scaled_dot_product_attention(qt, kt, vt),
            lambda: torch.autograd.grad(out, leaves, gt, retain_graph=True))
    flops = 4 * batch * heads * seq * seq * d
    nb = q.numel() * 2
    row = {"shape": list(shape),
           "bound_ms": [bound_ms(4 * nb + 8 * m.numel(), flops),
                        bound_ms(7 * nb + 8 * m.numel(), 2.5 * flops)]}
    if first is not None:
        old = first_calls(first, q, k, v, g)
        err = [close(a, b, "first version o") for a, b in
               zip(old[0]()[:1], (o,))]
        err += [close(a, b, f"first version {name}") for name, a, b in
                zip(("dq", "dk", "dv"), old[1](), grads)]
        row["max_abs_err_vs_first"] = max(err)
    for i, name in enumerate(("fwd", "bwd")):
        if first is not None:
            t = [cuda_ms(old[i], iters), cuda_ms(new[i], iters),
                 cuda_ms(new[i], iters), cuda_ms(old[i], iters)]
            row[f"{name}_ms"] = (t[1] + t[2]) / 2
            row[f"{name}_first_ms"] = (t[0] + t[3]) / 2
            row[f"{name}_first_device"] = device_ms(old[i])
        else:
            row[f"{name}_ms"] = cuda_ms(new[i], iters)
        row[f"{name}_device"] = device_ms(new[i])
        row[f"{name}_sdpa_ms"] = cuda_ms(sdpa[i], iters)
        row[f"{name}_sdpa_device"] = sum(device_ms(sdpa[i]).values())
    return row


def variant_rows(variants, rng):
    """The training shape's device times for each built variant, through
    the wrappers with the library swapped."""
    with ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(
            lambda kv: nvcc(kv[1], f"flash_attention_train_{kv[0]}"),
            variants))
    q, k, v, g = (torch.tensor(
        rng.standard_normal(TRAIN_SHAPE).astype(np.float32),
        dtype=torch.bfloat16, device="cuda") for _ in range(4))
    o, m, n = ft.mha_flash_trainable_fwd(q, k, v)
    ref = (o, *ft.mha_flash_trainable_bwd(q, k, v, g, m, n))
    lib0 = ft._lib
    rows = []
    try:
        for (name, source), (path, report) in zip(variants, built):
            lib = ft.declare(ctypes.CDLL(str(path)))
            ft._lib = lambda lib=lib: lib
            fwd = lambda: ft.mha_flash_trainable_fwd(q, k, v)  # noqa
            bwd = lambda: ft.mha_flash_trainable_bwd(q, k, v, g, m, n)  # noqa
            got = (fwd()[0], *bwd())
            err = max(close(a, b, f"variant {name}")
                      for a, b in zip(got, ref))
            rows.append({"variant": name, "source": source,
                         "registers": registers(report), "max_abs_err": err,
                         "fwd_device": device_ms(fwd),
                         "bwd_device": device_ms(bwd)})
            print(json.dumps(rows[-1]), flush=True)
    finally:
        ft._lib = lib0
    return rows


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--first-version", type=Path)
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--variant", action="append", default=[],
                        help="NAME=PATH: a patched copy of the source, with "
                        "its C interface, to time beside it")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    first = (first_library(args.first_version)
             if args.first_version else None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, env={**os.environ}).stdout.strip()
    print(smi)
    rng = np.random.default_rng(0)
    rows = [case(shape, args.iters, first, rng)
            for shape in (TRAIN_SHAPE, (1, 257, 12, 64))]
    variants = [tuple(v.split("=", 1)) for v in args.variant]
    tried = variant_rows(variants, rng) if variants else []
    print(json.dumps({"card": smi, "rows": rows, "variants": tried}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
