"""Times the differentiable flash attention's kernels
(hypervla_tpu_torch/csrc/flash_attention_train.cu through
ops/flash_attention_train.py) in bf16 or, with --dtype float32, fp32, at
the flagship's training shape (64, 257, 12, 64) and at the serving shape
(1, 257, 12, 64), beside scaled_dot_product_attention's forward and
backward and the bound of each, and, with --first-version PATH (that
source as an earlier commit had it: with the plain C interface it had
before the launch plan, or with the launch plan and the fp32 FMA kernels
that the fp32 route replaced), beside that version built into
build/tools/, in turns in one process (first, new, new, first). Each
call's time twice: by CUDA events (the mean over --iters calls after a
warm-up, the wrappers' host work included) and its kernels' device time
from torch.profiler traces (chip_smoke.py's kernel_device_ms, kernel by
kernel); the outputs of the two versions are held to one bf16 ulp of their
scale (bf16) or 2e-5 of it (fp32: each within 1e-5 of the plain version).
The bound is the bytes over 3.35 TB/s or the operations over 989 TFLOP/s
(bf16) or 989 / 6 (fp32: six bf16 term products an fp32 product),
whichever is larger. With --variant NAME=PATH (repeated) a patched copy of
the current source (its C interface and shared-memory layout unchanged,
e.g. another `Occupancy`) is also built into build/tools/, its registers
and spills printed from `-Xptxas -v`, and timed at the training shape
through the wrappers. Prints the card and one JSON line.

Run on the card:
    python3 tools/flash_train_ab.py [--dtype float32] [--first-version PATH]
        [--iters N] [--variant NAME=PATH ...]
(a variant named probe* is timed with its error reported, not held)
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
#: the fp32 route's rate: six bf16 term products an fp32 product
PEAK_FP32_SPLIT = PEAK_BF16 / 6
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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
    """{kernel: 'N registers, S bytes spilled'} of the kernels."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '_Z\d+(\w+?_kernel)"
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
    """The earlier source as a ctypes library with its own signatures:
    without a plan, or with the plan's rows and shared memory; the
    library's `planned` says which."""
    out, _ = nvcc(path, "flash_attention_train_first")
    lib = ctypes.CDLL(str(out))
    lib.planned = "int rows, int smem" in Path(path).read_text()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if lib.planned:
        lib.mha_flash_trainable_fwd.argtypes = [p] * 6 + [i] * 4 + [f] + \
            [i] * 5 + [p]
        lib.mha_flash_trainable_bwd.argtypes = [p] * 11 + [i] * 4 + [f] + \
            [i] * 6 + [p]
    else:
        lib.mha_flash_trainable_fwd.argtypes = [p] * 6 + [i] * 4 + [
            f, i, i, i, p]
        lib.mha_flash_trainable_bwd.argtypes = [p] * 10 + [i] * 4 + [
            f, i, i, i, p]
    return lib


def first_plan(batch_heads, seq, d, dtype):
    """The planned earlier source's launch plan: (rows, smem fwd, dq,
    dk/dv, nt, padded dim); its fp32 FMA kernels took 32-row blocks and
    their own layout."""
    if dtype == torch.float32:
        tile, rows = 64, 32
        return (rows, 4 * (2 * tile * (d + 1) + rows * (d + tile)),
                4 * (2 * tile * (d + 1) + rows * (2 * d + tile)),
                4 * (2 * rows * d + 2 * tile * (d + 1) + 3 * tile
                     + 2 * rows * tile), 1, d)
    plan = ft.flash_train_plan(batch_heads, seq, d, dtype)
    return (plan.rows, plan.smem_fwd, plan.smem_dq, plan.smem_dkdv,
            plan.q_terms, plan.padded_dim)


def first_calls(lib, q, k, v, g):
    """(forward, backward) closures of the earlier version on these
    inputs; the backward takes the forward's m, n."""
    batch, seq, heads, d = q.shape
    scale = ft.softmax_scale(d)
    f32 = int(q.dtype == torch.float32)
    o, dq, dk, dv = (torch.empty_like(q) for _ in range(4))
    m = torch.empty((batch, heads, seq), dtype=torch.float32, device=q.device)
    n = torch.empty_like(m)
    rows, smem_f, smem_q, smem_k, nt, dn = first_plan(batch * heads, seq, d,
                                                      q.dtype)
    # the row terms (r in fp32; four a row in bf16) and, in bf16 with three
    # q terms, those terms
    r = torch.empty((*m.shape, 1 if f32 else 4), dtype=torch.float32,
                    device=q.device)
    qx = None
    if lib.planned and not f32 and nt == 3:
        qx = torch.empty((batch * heads, 3, seq, dn), dtype=torch.bfloat16,
                         device=q.device)
    stream = torch.cuda.current_stream().cuda_stream
    plan_fwd = (rows, smem_f) if lib.planned else ()
    plan_bwd = (rows, smem_q, smem_k) if lib.planned else ()
    scratch = (None if qx is None else qx.data_ptr(),) if lib.planned else ()

    def fwd():
        code = lib.mha_flash_trainable_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            m.data_ptr(), n.data_ptr(), batch, heads, seq, d, scale, f32, nt,
            1, *plan_fwd, stream)
        assert code == 0, code
        return o, m, n

    def bwd():
        code = lib.mha_flash_trainable_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            m.data_ptr(), n.data_ptr(), r.data_ptr(), *scratch,
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), batch, heads, seq,
            d, scale, f32, nt, 1, *plan_bwd, stream)
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


def bound_ms(nbytes, flops, peak=PEAK_BF16):
    return max(nbytes / PEAK_BYTES, flops / peak) * 1e3


def close(got, ref, what):
    bound = 2e-5 if ref.dtype == torch.float32 else 2 ** -7
    got, ref = got.float(), ref.float()
    err = (got - ref).abs().max().item()
    limit = bound * max(ref.abs().max().item(), 1.0)
    if not err <= limit:
        raise AssertionError(f"{what}: {err} > {limit}")
    return err


def case(shape, iters, first, rng, dtype):
    q, k, v, g = (torch.tensor(rng.standard_normal(shape).astype(np.float32),
                               dtype=dtype, device="cuda")
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
    nb = q.numel() * q.element_size()
    peak = PEAK_FP32_SPLIT if dtype == torch.float32 else PEAK_BF16
    row = {"shape": list(shape), "dtype": str(dtype)[6:],
           "bound_ms": [bound_ms(4 * nb + 8 * m.numel(), flops, peak),
                        bound_ms(7 * nb + 8 * m.numel(), 2.5 * flops, peak)]}
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


def variant_rows(variants, rng, dtype):
    """The training shape's device times for each built variant, through
    the wrappers with the library swapped. A variant whose name starts
    with "probe" breaks the function on purpose (to see where the time
    goes): its error is reported, not held."""
    with ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(
            lambda kv: nvcc(kv[1], f"flash_attention_train_{kv[0]}"),
            variants))
    q, k, v, g = (torch.tensor(
        rng.standard_normal(TRAIN_SHAPE).astype(np.float32),
        dtype=dtype, device="cuda") for _ in range(4))
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
            if name.startswith("probe"):
                err = max((a.float() - b.float()).abs().max().item()
                          for a, b in zip(got, ref))
            else:
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
    parser.add_argument("--dtype", choices=sorted(DTYPES),
                        default="bfloat16")
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
    dtype = DTYPES[args.dtype]
    rows = [case(shape, args.iters, first, rng, dtype)
            for shape in (TRAIN_SHAPE, (1, 257, 12, 64))]
    variants = [tuple(v.split("=", 1)) for v in args.variant]
    tried = variant_rows(variants, rng, dtype) if variants else []
    print(json.dumps({"card": smi, "rows": rows, "variants": tried}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
