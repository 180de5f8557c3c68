#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the port's CUDA kernels (hypervla_tpu_torch/csrc) with nvcc, one
   process per source, all at once.
2. Kernel phase: runs each kernel of the DINOv2 serving trunk, and the
   12-layer trunk, at the flagship's shapes (seq 257, width 768) against its
   plain PyTorch version on the same inputs, and times both.
3. Slice phase: builds the full-width flagship from a seed, encodes an
   initial frame with the fp32 DINOv2, resets an InferenceWrapper with a
   random (1, 32, 768) instruction embedding and drives ~50 fused serving
   steps on random 256x256 frames (crop and ensembling on). Checks that every
   step went through the trunk kernels and that the actions match the same
   steps run with the plain trunk. Then a second serving configuration on
   the same weights: use_flash_attention=True and fused_layer_norm=True
   through the per-layer serving step (trunk_impl="layers"): 12 flash
   attention and 25 one-pass LayerNorm launches per step, the actions held
   against the same steps with both kernels' plain versions, timed beside
   the stacked-trunk step.
4. Row and flash kernel phase: the flash attention and the one-pass
   LayerNorm at the serving shapes (the flash attention also at B=64, as
   cross attention with 65 queries on 300 keys and at head dim 128; each
   twice bit for bit, its error against the exact function in fp64 beside
   that of the fp32-FMA kernel it replaced), the
   residual add + LayerNorm pair with and without LayerScale, forward and
   backward with both cotangents (the backward twice, bit-equal), and the
   fused exact GELU at the training shapes, each against its plain version,
   timed with its bound and the one PyTorch call for the same function.
   The add + LayerNorm without LayerScale lies on no model path: its
   differentiable function is driven once, counted, forward and backward.
   Training kernel phase, at B=64, S=257, H=12, D=64, width 768, each
   kernel against its plain version, both timed: the fused training
   attention forward and backward; the layer forward without residuals (one
   layer and 12 stacked) and with them (all outputs); the layer backward
   (dx, the weight gradients, dpv, db1), which must also repeat bit for bit
   and equal the sum over two half batches; the training LayerNorm forward
   and backward; and each kernel of csrc/layer_backward.cu and each GEMM
   shape of the layer alone.
5. Train phase: the full-width flagship at batch 64 through the entry
   points of scripts/bench_train.py (build_frozen_encoders,
   make_train_step), the frozen T5 and DINOv2 drawn from seeds, the LR at
   its peak, on one fixed batch, under three configurations: the fast
   training preset (fused attention in a cuBLAS trunk, the frozen encoder
   through the layer forward), and the fast preset with the layer-kernel
   trunk (hoist_shared_trunk, dino_layers_impl="pallas_train",
   fused_layer_norm="pallas_train": every trunk layer through the
   residual-saving layer forward and the layer backward, the final
   LayerNorm of both encoders through the training LayerNorm), and the fast
   preset with dino_fused_add_ln=True and HYPERVLA_FUSED_GELU=1 (set for
   that configuration's steps only): every residual boundary of the trunk
   through fused_add_scale_ln forward and backward, the trunk's GELU
   forward through the fused kernel. For each:
   every step's launches, a finite and falling loss, and the first step
   against the plain path (the same step with the kernel switches off);
   all four timed in turns.

The kernels redesigned for Hopper, the training attention (forward and
backward on the bf16 tensor cores), the layer and trunk GEMM (a pipelined
`wgmma` kernel), the layer backward's A^T.B weight gradients (`wgmma` on
MN-major operands, the rows split over blocks and finished in order) and
the flash attention, are also run twice and compared bit for bit, at every
GEMM shape of the serving trunk and of the training layer (every epilogue,
both layouts of the weight); at M = 16448 the rows of the ragged last row
tile are checked on their own, and a row past M, poisoned before the launch,
is found untouched after it; the weight gradients also at M = 16485 and 99.

Beside each kernel's time the script prints the least time the card could
take for the same work (the larger of bytes moved over 3.35 TB/s and
operations over the peak rate for their type: 989 TFLOP/s bf16 on the
tensor cores, 67 TFLOP/s fp32) and, where one PyTorch call computes the
same function (torch.matmul, F.layer_norm, F.gelu,
F.scaled_dot_product_attention, a sum), that call's time: a yardstick that
the port never calls. `ms` is CUDA events around back-to-back calls, which
for a kernel of a few microseconds is the rate its wrapper launches at;
`device_ms` is the kernels' own device time over the same calls, from a
torch.profiler trace.

Each serving step and each train configuration is also traced once with
torch.profiler: its device busy time (the sum of its kernels' device time)
and kernel count beside the unprofiled step time, i.e. the device's idle
share.

Prints the card's name and power limit, the per-phase results, a
{"kernels": [...]} JSON line, and as its last line
{"ok": true, "device": {...}}. Any failed check raises and exits non-zero
without that line. Needs a CUDA device: exits non-zero without one.
"""
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

STEPS = 50
SEED = 0
SOURCES = ("dino_layer.cu", "fused_attention.cu", "layer_backward.cu",
           "row_kernels.cu", "flash_attention.cu")
TRUNK_SOURCE = "hypervla_tpu_torch/csrc/dino_layer.cu"
TPU_KERNEL = "hypervla_tpu/ops/dino_layer.py:87"  # `_kernel`, the Pallas body
# the training kernels: (source, the Pallas body each replaces)
TRAIN_KERNELS = {
    "mha_fused_train_fwd": ("hypervla_tpu_torch/csrc/fused_attention.cu",
                            "hypervla_tpu/ops/fused_attention.py:49"),
    "mha_fused_train_bwd": ("hypervla_tpu_torch/csrc/fused_attention.cu",
                            "hypervla_tpu/ops/fused_attention.py:78"),
    "dino_layer_train_fwd": ("hypervla_tpu_torch/ops/dino_layer_train.py",
                             "hypervla_tpu/ops/dino_layer_train.py:139"),
    "dino_layer_train_fwd_res": (
        "hypervla_tpu_torch/ops/dino_layer_train.py",
        "hypervla_tpu/ops/dino_layer_train.py:139"),
    "dino_layer_train_bwd": ("hypervla_tpu_torch/ops/dino_layer_train.py",
                             "hypervla_tpu/ops/dino_layer_train.py:188"),
    "layer_norm_pallas_fwd": ("hypervla_tpu_torch/csrc/dino_layer.cu",
                              "hypervla_tpu/ops/layer_norm.py:201"),
    "layer_norm_pallas_bwd": ("hypervla_tpu_torch/csrc/layer_backward.cu",
                              "hypervla_tpu/ops/layer_norm.py:211"),
    # the launches a layer's backward adds to the forward's kernels
    "dino_gemm_train": ("hypervla_tpu_torch/csrc/dino_layer.cu",
                        "hypervla_tpu/ops/dino_layer_train.py:188"),
    "layer_gemm_tn": ("hypervla_tpu_torch/csrc/layer_backward.cu",
                      "hypervla_tpu/ops/dino_layer_train.py:188"),
    "layer_norm_bwd_rows": ("hypervla_tpu_torch/csrc/layer_backward.cu",
                            "hypervla_tpu/ops/dino_layer_train.py:82"),
    "layer_scale_grad": ("hypervla_tpu_torch/csrc/layer_backward.cu",
                         "hypervla_tpu/ops/dino_layer_train.py:216"),
    "layer_gelu_bwd": ("hypervla_tpu_torch/csrc/layer_backward.cu",
                       "hypervla_tpu/ops/dino_layer_train.py:90"),
    "layer_colsum": ("hypervla_tpu_torch/csrc/layer_backward.cu",
                     "hypervla_tpu/ops/dino_layer_train.py:289"),
}
# the forward-only serving kernels, the fused residual boundaries and the
# fused GELU: (source, the Pallas body each replaces)
ROW_SOURCE = "hypervla_tpu_torch/csrc/row_kernels.cu"
ROW_FLASH_KERNELS = {
    "flash_attention": ("hypervla_tpu_torch/csrc/flash_attention.cu",
                        "hypervla_tpu/ops/flash_attention.py:22"),
    "layer_norm": (ROW_SOURCE, "hypervla_tpu/ops/layer_norm.py:17"),
    "fused_add_ln_fwd": (ROW_SOURCE, "hypervla_tpu/ops/add_layer_norm.py:57"),
    "fused_add_ln_bwd": (ROW_SOURCE, "hypervla_tpu/ops/add_layer_norm.py:70"),
    "fused_add_scale_ln_fwd": (ROW_SOURCE,
                               "hypervla_tpu/ops/add_layer_norm.py:207"),
    "fused_add_scale_ln_bwd": (ROW_SOURCE,
                               "hypervla_tpu/ops/add_layer_norm.py:221"),
    "gelu_exact_fused": (ROW_SOURCE, "hypervla_tpu/ops/gelu.py:63"),
}
# the card's published peaks (H100 SXM): device memory, dense bf16 on the
# tensor cores, fp32 outside them
PEAK_BYTES, PEAK_BF16, PEAK_FP32 = 3.35e12, 989e12, 67e12
# kernel-vs-plain bounds: one bf16 ulp of the output scale for one kernel
# launch; the bounds the JAX package holds between its own trunks for the
# 12-layer trunk and for the actions
ULP_BOUND = 2 ** -7
TRUNK_BOUND = 0.05
# the attention backward rounds ds to bf16 between two products; one
# composed layer is seven launches
GRAD_BOUND = 2 ** -5
LAYER_BOUND = 2 ** -6
# the train phase: batch, steps, and the bounds the JAX package holds
# between its own trunks (tests/test_layer_kernel_train_step.py)
TRAIN_BATCH = 64
# calls of a kernel traced for its device time
PROFILED_CALLS = 10
TRAIN_WARMUP, TRAIN_STEPS = 2, 6
# the layer backward: cosine per output against the plain version (the JAX
# package holds its kernel to 0.99 per leaf, tests/test_dino_layer_train.py)
GRAD_COSINE_BOUND = 0.999
STEP_REL_BOUND = 0.02
COSINE_BOUND = 0.98


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters):
    """Mean device ms per call of fn over `iters` calls (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def interleaved(kernel_fn, plain_fn, iters):
    """(kernel ms, plain ms), timed in turns: plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain_fn, iters)
    k1 = cuda_ms(kernel_fn, iters)
    k2 = cuda_ms(kernel_fn, iters)
    p2 = cuda_ms(plain_fn, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def device_busy(fn, calls=1):
    """(device busy ms, device kernels) per call of fn, from a
    torch.profiler trace of `calls` identical calls: the sum of the kernels'
    own device time (one stream, so they do not overlap)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # a trace now and then comes back without its device records: it is
    # taken again, and only a third empty one fails the run
    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.count > 0]
        # a trace often lacks the record of a launch or two: each kernel's
        # mean time over the records that are there, times its launches a
        # call (the records over the calls, rounded)
        per_call = [(e.self_device_time_total / e.count,
                     max(1, round(e.count / calls))) for e in rows]
        busy_us = sum(mean_us * n for mean_us, n in per_call)
        if busy_us > 0:
            return busy_us / 1e3, sum(n for _, n in per_call)
        log(f"profiler: trace {attempt + 1} of {calls} calls held no device "
            "time")
    raise AssertionError("the profiler saw no device time")


def confirmed_device_ms(fn, calls):
    """Device ms per call of fn from two traces of `calls` calls that agree
    (the same number of device kernels, times within a quarter): a trace now
    and then comes back without any of one kernel's records, which a single
    trace cannot tell from a faster function."""
    prev = device_busy(fn, calls)
    for _ in range(3):
        cur = device_busy(fn, calls)
        if (cur[1] == prev[1]
                and abs(cur[0] - prev[0]) <= 0.25 * max(cur[0], prev[0])):
            return (cur[0] + prev[0]) / 2
        log(f"profiler: two traces disagree ({prev[0]:.6g} ms in {prev[1]:g} "
            f"kernels, then {cur[0]:.6g} ms in {cur[1]:g}); tracing again")
        prev = cur
    raise AssertionError("no two profiler traces in a row agree")


def bound_ms(nbytes, flops, peak=PEAK_BF16):
    """The least time the card could take: (ms, what sets it), the larger
    of the bytes moved over the memory rate and the operations over the
    peak rate for their type."""
    by_bytes, by_ops = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


class KernelTable:
    """Each kernel's times beside its bound. `add` times one call of a
    kernel in turns with its plain version, the one PyTorch call for the
    same function where there is one, and the kernel's device time from a
    profiler trace of the same calls; calls under one name add up (one
    layer's launches of that kernel). `rows` gives, per name, the keys the
    {"kernels": [...]} line carries."""

    def __init__(self):
        self._rows = {}

    def add(self, name, label, err, kernel_fn, plain_fn, iters, cost,
            library=None):
        """cost: (bytes moved, operations, the peak rate of their type)."""
        k_ms, p_ms = interleaved(kernel_fn, plain_fn, iters)
        lib_ms = cuda_ms(library, iters) if library else None
        # the same calls under the profiler: the kernels' own device time,
        # where `ms` of a short kernel is the rate its wrapper launches at
        calls = min(iters, PROFILED_CALLS)
        dev_ms = confirmed_device_ms(kernel_fn, calls)
        lib_dev = confirmed_device_ms(library, calls) if library else None
        least, by = bound_ms(*cost)

        def fmt(ms):
            return "none" if ms is None else format(ms, ".6g")

        log(f"kernel {name} {label}: ms {k_ms:.6g} device_ms {dev_ms:.6g} "
            f"plain_ms {p_ms:.6g} library_ms {fmt(lib_ms)} "
            f"library_device_ms {fmt(lib_dev)} bound_ms {least:.6g} ({by})")
        r = self._rows.setdefault(name, {
            "max_abs_err": 0.0, "ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
            "library_ms": None, "library_device_ms": None, "bytes": 0.0,
            "ops": 0.0, "peak": cost[2]})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += k_ms
        r["device_ms"] += dev_ms
        r["plain_ms"] += p_ms
        if lib_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + lib_ms
            r["library_device_ms"] = ((r["library_device_ms"] or 0.0)
                                      + lib_dev)
        r["bytes"] += cost[0]
        r["ops"] += cost[1]

    def log_rows(self, where):
        """Logs each name's summed row, labelled `where`; returns rows()."""
        results = self.rows()
        for name, r in results.items():
            log(f"kernel {name}{where}: " + " ".join(
                f"{key} {'none' if r[key] is None else format(r[key], '.6g')}"
                for key in ("ms", "device_ms", "plain_ms", "library_ms",
                            "library_device_ms", "bound_ms"))
                + f" ({r['bound_by']})")
        return results

    def rows(self):
        out = {}
        for name, r in self._rows.items():
            least, by = bound_ms(r["bytes"], r["ops"], r["peak"])
            out[name] = {key: r[key] for key in (
                "max_abs_err", "ms", "device_ms", "plain_ms", "library_ms",
                "library_device_ms")}
            out[name].update(bound_ms=least, bound_by=by)
        return out


def max_err(got, ref):
    import torch

    if not torch.isfinite(got.float()).all():
        raise AssertionError("non-finite kernel output")
    return ((got.float() - ref.float()).abs().max().item(),
            ref.float().abs().max().item())


def kernel_phase(device):
    """Checks and times every trunk kernel at the flagship's shapes."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from hypervla_tpu_torch.ops import dino_layer as dl

    seq, hidden, layers = 257, 768, 12
    rng = np.random.default_rng(SEED)

    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a, np.float32), dtype=dtype,
                            device=device)

    x = t(rng.standard_normal((seq, hidden)) * 0.5, torch.bfloat16)
    w = t(rng.standard_normal((layers, 3, hidden, 4 * hidden)) * 0.02,
          torch.bfloat16)
    b = t(rng.standard_normal((layers, 3, 4 * hidden)) * 0.02)
    p = t(np.concatenate([
        1 + 0.1 * rng.standard_normal((layers, 1, hidden)),
        0.1 * rng.standard_normal((layers, 1, hidden)),
        1 + 0.1 * rng.standard_normal((layers, 1, hidden)),
        0.1 * rng.standard_normal((layers, 1, hidden)),
        0.1 + 0.02 * rng.standard_normal((layers, 2, hidden)),
    ], axis=1))
    h_in = t(rng.standard_normal((seq, 4 * hidden)) * 0.5, torch.bfloat16)
    qkv = t(rng.standard_normal((seq, 3 * hidden)) * 2.0, torch.bfloat16)
    hd = hidden

    def gemm_cost(a, w_t, *extra):
        m, k = a.shape
        n = w_t.numel() // k
        return nbytes(a, w_t, *extra) + 2 * m * n, 2 * m * n * k, PEAK_BF16

    def ln_case(label, s_row, b_row):
        sc, bi = p[0, s_row], p[0, b_row]
        sc16, bi16 = sc.bfloat16(), bi.bfloat16()
        return (label, dl.layer_norm_rows, dl.layer_norm_rows_reference,
                (x, sc, bi, 1e-6),
                lambda: F.layer_norm(x, (hidden,), sc16, bi16, 1e-6),
                (nbytes(x, x, sc, bi), 8 * x.numel(), PEAK_FP32))

    w_qkv, w_o = w[0, 0, :, :3 * hd], w[0, 0, :, 3 * hd:]
    heads = hidden // 64
    q4, k4, v4 = (qkv[:, i * hd:(i + 1) * hd].reshape(seq, heads, 64)
                  .transpose(0, 1)[None] for i in range(3))
    # one layer's launches of each kernel, as the trunk makes them:
    # (label, kernel, plain, args, the one PyTorch call, (bytes, ops, peak))
    cases = {
        "dino_layer_norm": [ln_case("ln1", dl.LN1_S, dl.LN1_B),
                            ln_case("ln2", dl.LN2_S, dl.LN2_B)],
        "dino_gemm": [
            ("qkv [257,768]x[768,2304]", dl.gemm, dl.gemm_reference,
             (x, w_qkv, b[0, 0, :3 * hd]), lambda: x @ w_qkv,
             gemm_cost(x, w_qkv, b[0, 0, :3 * hd])),
            ("out-proj [257,768]x[768,768] +residual", dl.gemm,
             dl.gemm_reference, (x, w_o, b[0, 0, 3 * hd:], "residual", x,
                                 p[0, dl.LS1]), lambda: x @ w_o,
             gemm_cost(x, w_o, b[0, 0, 3 * hd:], x, p[0, dl.LS1])),
            ("fc1 [257,768]x[768,3072] +gelu", dl.gemm, dl.gemm_reference,
             (x, w[0, 1], b[0, 1], "gelu"), lambda: x @ w[0, 1],
             gemm_cost(x, w[0, 1], b[0, 1])),
            ("fc2 [257,3072]x[768,3072]^T +residual", dl.gemm,
             dl.gemm_reference, (h_in, w[0, 2], b[0, 2, :hd], "residual", x,
                                 p[0, dl.LS2], True),
             lambda: h_in @ w[0, 2].t(),
             gemm_cost(h_in, w[0, 2], b[0, 2, :hd], x, p[0, dl.LS2])),
        ],
        "dino_attention": [
            ("12 heads x 257 tokens", dl.attention, dl.attention_reference,
             (qkv,), lambda: F.scaled_dot_product_attention(q4, k4, v4),
             (nbytes(qkv) + 2 * seq * hd, 4 * seq * seq * hd, PEAK_BF16)),
        ],
    }
    table = KernelTable()
    for name, calls in cases.items():
        for label, kern, plain, args, library, cost in calls:
            got = kern(*args)
            torch.cuda.synchronize()
            err, scale = max_err(got, plain(*args))
            bound = ULP_BOUND * max(scale, 1.0)
            note = ""
            if name == "dino_gemm":
                a, w_t = args[0], args[1]
                cfg = dl.gemm_config(a.shape[0], w_t.numel() // a.shape[1],
                                     a.shape[1])
                note = (f"; tile {cfg.block_m}x{cfg.block_n}, split-K "
                        f"{cfg.split_k}")
            log(f"kernel {name} {label}: max_abs_err {err:.6g} (bound "
                f"{bound:.6g}); a second run is bit-equal{note}")
            if not err <= bound:
                raise AssertionError(f"{name} {label}: {err} > {bound}")
            if not torch.equal(got, kern(*args)):
                raise AssertionError(f"{name} {label}: two runs differ")
            table.add(name, label, err, lambda: kern(*args),
                      lambda: plain(*args), 200, cost, library)

    got = dl.dino_layers_serving(x, w, b, p)
    torch.cuda.synchronize()
    err, scale = max_err(got, dl.dino_layers_serving_reference(x, w, b, p))
    bound = TRUNK_BOUND * max(scale, 1.0)
    log(f"kernel dino_layers_serving 12 layers: max_abs_err {err:.6g} "
        f"(bound {bound:.6g})")
    if not err < bound:
        raise AssertionError(f"12-layer trunk: {err} >= {bound}")
    # each input read once, the output written once; per layer the four
    # GEMMs and the attention products
    trunk_ops = layers * (2 * seq * hidden * 12 * hidden
                          + 4 * seq * seq * hidden)
    table.add("dino_layers_serving", "12 layers", err,
              lambda: dl.dino_layers_serving(x, w, b, p),
              lambda: dl.dino_layers_serving_reference(x, w, b, p), 20,
              (nbytes(x, w, b, p, x), trunk_ops, PEAK_BF16))
    results = table.log_rows(" at bs=1, a layer's launches (the trunk: 12 "
                             "layers)")
    weight_bytes = w.numel() * 2
    trunk_ms = results["dino_layers_serving"]["ms"]
    log(f"trunk weights {weight_bytes / 1e6:.1f} MB; kernel trunk reads them "
        f"at {weight_bytes / (trunk_ms * 1e-3) / 1e9:.1f} GB/s effective")
    return results


def row_flash_kernel_phase(device):
    """Checks and times the forward-only serving kernels at the serving
    shapes (the flash attention at B=64 too) and the fused residual
    boundaries and the fused GELU at the training shapes."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from hypervla_tpu_torch.ops import add_layer_norm as aln
    from hypervla_tpu_torch.ops import flash_attention as fa
    from hypervla_tpu_torch.ops import gelu as tg
    from hypervla_tpu_torch.ops import layer_norm as tln

    seq, heads, hidden, batch = 257, 12, 768, TRAIN_BATCH
    rng = np.random.default_rng(SEED + 3)

    def t(shape, dtype=torch.bfloat16, scale=1.0, shift=0.0):
        return torch.tensor(
            (rng.standard_normal(shape) * scale + shift).astype(np.float32),
            dtype=dtype, device=device)

    def check(name, label, got, ref, bound=ULP_BOUND):
        err, ref_scale = max_err(got, ref)
        limit = bound * max(ref_scale, 1.0)
        log(f"kernel {name} {label}: max_abs_err {err:.6g} (bound "
            f"{limit:.6g})")
        if not err <= limit:
            raise AssertionError(f"{name} {label}: {err} > {limit}")
        return err

    table = KernelTable()

    # ---- kernel 4: flash attention over (B, S, heads, d), as the layer
    # reshapes its Dense outputs; both products on the bf16 tensor cores, P
    # kept in fp32 as three bf16 terms ----
    def flash_case(name, b, q_len, kv_len, h, d, iters):
        q = t((b, q_len, h, d))
        k, v = (t((b, kv_len, h, d)) for _ in range(2))
        got = fa.mha_flash(q, k, v)
        torch.cuda.synchronize()
        shape = f"q ({b}, {q_len}, {h}, {d}) kv_len {kv_len} bf16"
        err = check(name, shape, got, fa.mha_flash_reference(q, k, v))
        if not torch.equal(got, fa.mha_flash(q, k, v)):
            raise AssertionError(f"{name}: two runs differ")
        # against the exact function (fp64 on the same bf16 inputs): the
        # tensor-core kernel beside the fp32-FMA kernel it replaced
        q64, k64, v64 = (a.double().transpose(1, 2) for a in (q, k, v))
        exact = (torch.softmax(q64 @ k64.transpose(-1, -2) / math.sqrt(d), -1)
                 @ v64).transpose(1, 2)
        fma = fa.mha_flash_fma(q, k, v)
        err_tc = float((got.double() - exact).abs().max())
        err_fma = float((fma.double() - exact).abs().max())
        err_plain = float((fa.mha_flash_reference(q, k, v).double()
                           - exact).abs().max())
        del q64, k64, v64
        warps = fa.flash_warps(b * h, q_len)
        log(f"kernel {name} {shape}: three-term P split, max_abs_err against "
            f"fp64 {err_tc:.6g} (the FMA kernel {err_fma:.6g}, the plain "
            f"version {err_plain:.6g}); two runs bit-equal; grid "
            f"({-(-q_len // (16 * warps))}, {b * h}) blocks of {warps} warps")
        # both round the same fp32 value up to the order of its sum
        slack = 1e-6 * max(float(exact.abs().max()), 1.0)
        if not err_tc <= err_fma + slack:
            raise AssertionError(f"{name}: error {err_tc} against fp64 above "
                                 f"the FMA kernel's {err_fma}")
        del exact
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        # q.k^T and one P.V product per bf16 term of P, on the tensor cores
        table.add(name, shape, err, lambda: fa.mha_flash(q, k, v),
                  lambda: fa.mha_flash_reference(q, k, v), iters,
                  (nbytes(q, k, v, got), 8 * b * h * q_len * kv_len * d,
                   PEAK_BF16),
                  lambda: F.scaled_dot_product_attention(qt, kt, vt))
        fma_ms = cuda_ms(lambda: fa.mha_flash_fma(q, k, v), iters)
        fma_dev = confirmed_device_ms(lambda: fa.mha_flash_fma(q, k, v),
                                      min(iters, PROFILED_CALLS))
        log(f"kernel {name} {shape}: the FMA kernel it replaced ms "
            f"{fma_ms:.6g} device_ms {fma_dev:.6g}")

    with torch.no_grad():
        flash_case("flash_attention", 1, seq, seq, heads, 64, 200)
        flash_case("flash_attention_b64", batch, seq, seq, heads, 64, 10)
        flash_case("flash_attention_cross", 2, 65, 300, heads, 64, 50)
        flash_case("flash_attention_d128", 2, seq, seq, 6, 128, 50)

        # ---- kernel 5: the one-pass LayerNorm, bf16-stored vectors ----
        x = t((1, seq, hidden), scale=0.5, shift=0.3)
        sc, bi = t((hidden,), scale=0.1, shift=1.0), t((hidden,), scale=0.1)
        got = tln.layer_norm(x, sc, bi, 1e-6)
        torch.cuda.synchronize()
        err = check("layer_norm", "(1, 257, 768) bf16", got,
                    tln.layer_norm_reference(x, sc, bi, 1e-6))
        table.add("layer_norm", "", err,
                  lambda: tln.layer_norm(x, sc, bi, 1e-6),
                  lambda: tln.layer_norm_reference(x, sc, bi, 1e-6), 200,
                  (nbytes(x, x, sc, bi), 8 * x.numel(), PEAK_FP32),
                  lambda: F.layer_norm(x, (hidden,), sc, bi, 1e-6))

        # ---- kernel 9: the fused GELU at the fc1 output's shape ----
        h = t((batch, seq, 4 * hidden), scale=1.5)
        got = tg.gelu_exact_fused(h)
        torch.cuda.synchronize()
        err = check("gelu_exact_fused", "(64, 257, 3072) bf16", got,
                    tg.gelu_exact_reference(h))
        table.add("gelu_exact_fused", "", err,
                  lambda: tg.gelu_exact_fused(h),
                  lambda: tg.gelu_exact_reference(h), 20,
                  (nbytes(h, h), 20 * h.numel(), PEAK_FP32),
                  lambda: F.gelu(h))
        del h, got

    # ---- kernels 7 and 8: the residual boundaries, forward and backward ----
    rows = batch * seq
    x, delta, gy, gxn = (t((rows, hidden), scale=s)
                         for s in (2.0, 1.0, 1.0, 1.0))
    ls = t((hidden,), torch.float32, 0.02, 0.1)
    scale = t((hidden,), torch.float32, 0.1, 1.0)
    bias = t((hidden,), torch.float32, 0.1)
    for name, vec in (("fused_add_ln", None), ("fused_add_scale_ln", ls)):
        xn, y = aln.add_ln_fwd(x, delta, vec, scale, bias, 1e-6)
        torch.cuda.synchronize()
        ref_xn, ref_y = aln.add_ln_fwd_reference(x, delta, vec, scale, bias,
                                                 1e-6)
        if not torch.equal(xn, ref_xn):
            raise AssertionError(f"{name}: x_new differs from the plain "
                                 "version's roundings")
        err = check(f"{name}_fwd", "y (16448, 768) bf16", y, ref_y)
        log(f"kernel {name}_fwd x_new: bit-equal to the plain version")
        extra = () if vec is None else (vec,)
        table.add(f"{name}_fwd", "", err,
                  lambda: aln.add_ln_fwd(x, delta, vec, scale, bias, 1e-6),
                  lambda: aln.add_ln_fwd_reference(x, delta, vec, scale, bias,
                                                   1e-6), 50,
                  (nbytes(x, delta, xn, y, scale, bias, *extra),
                   12 * x.numel(), PEAK_FP32))
        got = aln.add_ln_bwd(gy, gxn, xn, delta, vec, scale, 1e-6)
        torch.cuda.synchronize()
        again = aln.add_ln_bwd(gy, gxn, xn, delta, vec, scale, 1e-6)
        ref = aln.add_ln_bwd_reference(gy, gxn, xn, delta, vec, scale, 1e-6)
        errs = []
        # dls, dscale, dbias: fp32 sums of 16448 terms in another order
        for out, a, b, c, bound in zip(
                ("dx", "ddelta", "dls", "dscale", "dbias"), got, again, ref,
                (ULP_BOUND, ULP_BOUND, 1e-4, 1e-4, 1e-4)):
            if c is None:
                continue
            if not torch.equal(a, b):
                raise AssertionError(f"{name}_bwd {out}: two runs differ")
            errs.append(check(f"{name}_bwd", out, a, c, bound))
        log(f"kernel {name}_bwd: two runs bit-equal")
        if vec is None and got[0] is not got[1]:
            raise AssertionError("fused_add_ln: dx and ddelta are two buffers")
        moved = ((gy, gxn, xn, got[0], scale, scale, scale) if vec is None
                 else (gy, gxn, xn, delta, got[0], got[1], vec, vec, scale,
                       scale, scale))
        table.add(f"{name}_bwd", "", max(errs),
                  lambda: aln.add_ln_bwd(gy, gxn, xn, delta, vec, scale,
                                         1e-6),
                  lambda: aln.add_ln_bwd_reference(gy, gxn, xn, delta, vec,
                                                   scale, 1e-6), 50,
                  (nbytes(*moved), 24 * x.numel(), PEAK_FP32))
        del got, again, ref, xn, y, ref_xn, ref_y

    # fused_add_ln (no LayerScale) lies on no model path of either package:
    # its path is the differentiable function itself, driven once here with
    # the counts at zero, forward and backward with both cotangents, over
    # the trunk's (B, S, width) tensors
    aln.reset_launch_counts()
    shape = (batch, seq, hidden)
    leaves = [a.view(shape).requires_grad_(True) for a in (x, delta)]
    params = [a.clone().requires_grad_(True) for a in (scale, bias)]
    xn, y = aln.fused_add_ln(*leaves, *params, 1e-6)
    torch.autograd.backward((xn, y), (gxn.view(shape), gy.view(shape)))
    torch.cuda.synchronize()
    driven = {name: aln.LAUNCHES[name]
              for name in ("fused_add_ln_fwd", "fused_add_ln_bwd")}
    ref = aln.add_ln_bwd_reference(gy, gxn, xn.detach().view(rows, hidden),
                                   None, None, scale, 1e-6)
    check("fused_add_ln", "function dx", leaves[0].grad.view(rows, hidden),
          ref[0])
    check("fused_add_ln", "function dscale", params[0].grad, ref[3], 1e-4)
    check("fused_add_ln", "function dbias", params[1].grad, ref[4], 1e-4)
    check("fused_add_ln", "function ddelta",
          leaves[1].grad.view(rows, hidden), ref[1])
    log(f"fused_add_ln function launches: {driven}")
    if driven != {"fused_add_ln_fwd": 1, "fused_add_ln_bwd": 1}:
        raise AssertionError(f"fused_add_ln launches {driven}, want one "
                             "forward and one backward")
    del leaves, params, xn, y, ref

    return table.log_rows(", per launch"), driven


def make_wrapper(model, trunk_impl):
    from hypervla_tpu_torch.eval.inference import InferenceWrapper

    return InferenceWrapper(model, policy_setup="google_robot",
                            image_size=224, action_ensemble=True, crop=True,
                            trunk_impl=trunk_impl)


def slice_phase(device):
    """Drives the full-width flagship through the serving entry points: the
    stacked-trunk step, then the per-layer step with the flash attention
    and the one-pass LayerNorm. Returns the launches of each."""
    import copy

    import numpy as np
    import torch

    from hypervla_tpu_torch.eval.inference import initial_state
    from hypervla_tpu_torch.flagship import build_flagship
    from hypervla_tpu_torch.models.base_network import BaseNetwork
    from hypervla_tpu_torch.models.hypervla import HyperVLA
    from hypervla_tpu_torch.ops import dino_layer as dl
    from hypervla_tpu_torch.ops import flash_attention as fa
    from hypervla_tpu_torch.ops import layer_norm as tln

    rng = np.random.default_rng(SEED)
    stats = {"action": {
        "mean": rng.standard_normal(7).astype(np.float32) * 0.1,
        "std": (1 + rng.random(7)).astype(np.float32),
        "mask": np.array([True] * 6 + [False]),
    }}
    t0 = time.perf_counter()
    model, batch = build_flagship(seed=SEED, device=device,
                                  dataset_statistics=stats)
    # random fan-out kernels make the generated weights depend on the task
    gen = torch.Generator().manual_seed(SEED + 1)
    for name, value in model.params.items():
        if name.startswith("output_head_") and name.endswith("/kernel"):
            value += (torch.randn(value.shape, generator=gen) * 0.02).to(
                value.device)
    torch.cuda.synchronize()
    log(f"slice flagship build s {time.perf_counter() - t0:.3f}")

    frames = rng.integers(0, 256, (STEPS + 1, 256, 256, 3), dtype=np.uint8)
    instruction = {"language_instruction":
                   batch["task"]["language_instruction"]}

    t0 = time.perf_counter()
    init = initial_state(model, frames[0])
    torch.cuda.synchronize()
    log(f"slice initial-image encode (fp32 DINOv2) ms "
        f"{(time.perf_counter() - t0) * 1e3:.3f}")
    policy = make_wrapper(model, "kernel")
    plain = make_wrapper(model, "reference")
    setup_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        policy.reset("pick up the cube", instruction, init)
        torch.cuda.synchronize()
        setup_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"slice episode setup ms (reset: hypernet + prepare + stack) "
        f"first {setup_ms[0]:.3f} then {setup_ms[1:]}")
    plain.reset("pick up the cube", instruction, init)

    # the main path, counted: every kernel launch below is the serving step's
    dl.reset_launch_counts()
    actions = [policy.step(f)[0] for f in frames[1:]]
    torch.cuda.synchronize()
    launches = dict(dl.LAUNCHES)
    log(f"slice launches over {STEPS} steps: {launches}")
    if launches["dino_layers_serving"] != STEPS:
        raise AssertionError("not every step went through the trunk kernel")
    depth = model.base_net.encoder.dino.num_hidden_layers
    width = model.base_net.encoder.dino.hidden_size
    # seven wrapper launches a layer; a split-K GEMM's finishing pass is a
    # second device kernel inside its one wrapper launch
    want = {"dino_layer_norm": 2 * depth * STEPS,
            "dino_gemm": 4 * depth * STEPS, "dino_attention": depth * STEPS,
            "dino_layers_serving": STEPS}
    if launches != want:
        raise AssertionError(f"stacked serving launches {launches}, want "
                             f"{want}")
    split = [dl.gemm_config(257, n, k).split_k
             for n, k in ((3 * width, width), (width, width),
                          (4 * width, width), (width, 4 * width))]
    log(f"slice stacked step: 7 launches a layer (2 LayerNorms, 4 GEMMs, 1 "
        f"attention); split-K of the 4 GEMMs {split}: "
        f"{sum(x > 1 for x in split)} finishing passes a layer")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {name} was not launched")
    actions = np.stack(actions)
    if actions.shape != (STEPS, 7) or not np.isfinite(actions).all():
        raise AssertionError(f"bad actions {actions.shape}")

    plain_actions = np.stack([plain.step(f)[0] for f in frames[1:]])
    scale = max(np.abs(plain_actions[:, :6]).max(), 1.0)
    arm_err = float(np.abs(actions[:, :6] - plain_actions[:, :6]).max())
    grip_agree = float((actions[:, 6] == plain_actions[:, 6]).mean())
    log(f"slice actions kernel vs plain trunk: arm max_abs_err {arm_err:.6g} "
        f"(bound {TRUNK_BOUND * scale:.6g}), gripper agreement "
        f"{grip_agree:.3f}; first action {actions[0].tolist()}")
    if not arm_err < TRUNK_BOUND * scale:
        raise AssertionError("actions disagree with the plain trunk")

    # the gripper logits themselves (a thresholded logit near 0 may flip)
    image = torch.as_tensor(frames[1][:224, :224], device=device)[None]
    logits = {}
    for impl in ("kernel", "reference"):
        tokens = model.base_net.encode(policy.base_params, image, impl)
        logits[impl] = model.base_net.action_head(policy.base_params,
                                                  tokens)[1].flatten()
    err, lscale = max_err(logits["kernel"], logits["reference"])
    log(f"slice gripper logits kernel vs plain: max_abs_err {err:.6g} "
        f"(bound {TRUNK_BOUND * max(lscale, 1.0):.6g})")
    if not err < TRUNK_BOUND * max(lscale, 1.0):
        raise AssertionError("gripper logits disagree with the plain trunk")

    # per-step time, in turns: plain, kernel, kernel, plain
    def window(wrapper, n=20):
        times = []
        for f in frames[1:n + 1]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            wrapper.step(f)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return times

    plain_ms = window(plain)
    kernel_ms = window(policy) + window(policy)
    plain_ms += window(plain)
    k_med, p_med = statistics.median(kernel_ms), statistics.median(plain_ms)
    log(f"slice per-step ms (median of CUDA events): kernel trunk {k_med:.4f} "
        f"plain trunk {p_med:.4f}; actions/s kernel {1e3 / k_med:.1f} "
        f"plain {1e3 / p_med:.1f}")
    del plain

    # ---- the second serving configuration: the per-layer serving step ----
    # the same weights; attention through the flash kernel, every LayerNorm
    # of the trunk through the one-pass kernel, the Dense layers cuBLAS
    config = copy.deepcopy(model.config)
    config["base_net_kwargs"]["vit_kwargs"].update(
        use_flash_attention=True, fused_layer_norm=True,
        sow_dino_attention=False)
    flash_model = HyperVLA(model.hypernet,
                           BaseNetwork(**config["base_net_kwargs"]), config,
                           model.params, model.plan, stats, device)
    layers = make_wrapper(flash_model, "layers")
    layers_plain = make_wrapper(flash_model, "layers_reference")
    for wrapper in (layers, layers_plain):
        wrapper.reset("pick up the cube", instruction, init)
    depth = flash_model.base_net.encoder.dino.num_hidden_layers
    per_step = {"flash_attention": depth, "layer_norm": 2 * depth + 1}

    # the main path, counted: every launch below is the per-layer step's
    for module in (dl, fa, tln):
        module.reset_launch_counts()
    actions = [layers.step(f)[0] for f in frames[1:]]
    torch.cuda.synchronize()
    got = {"flash_attention": fa.LAUNCHES["flash_attention"],
           "layer_norm": tln.LAUNCHES["layer_norm"]}
    log(f"slice per-layer serving launches over {STEPS} steps: {got}")
    if got != {k: v * STEPS for k, v in per_step.items()}:
        raise AssertionError(f"per-layer serving launches {got}, want "
                             f"{per_step} per step")
    if any(dl.LAUNCHES.values()):
        raise AssertionError("the per-layer step went through the stacked "
                             "trunk's kernels")
    actions = np.stack(actions)
    if actions.shape != (STEPS, 7) or not np.isfinite(actions).all():
        raise AssertionError(f"bad per-layer actions {actions.shape}")
    plain_actions = np.stack([layers_plain.step(f)[0] for f in frames[1:]])
    if fa.LAUNCHES["flash_attention"] != got["flash_attention"]:
        raise AssertionError("the plain versions launched a kernel")
    scale = max(np.abs(plain_actions[:, :6]).max(), 1.0)
    arm_err = float(np.abs(actions[:, :6] - plain_actions[:, :6]).max())
    grip_agree = float((actions[:, 6] == plain_actions[:, 6]).mean())
    log(f"slice per-layer actions kernels vs their plain versions: arm "
        f"max_abs_err {arm_err:.6g} (bound {TRUNK_BOUND * scale:.6g}), "
        f"gripper agreement {grip_agree:.3f}; first action "
        f"{actions[0].tolist()}")
    if not arm_err < TRUNK_BOUND * scale:
        raise AssertionError("per-layer actions disagree with the plain "
                             "versions")
    # beside the stacked-trunk step, in turns
    stacked_ms = window(policy)
    layers_ms = window(layers) + window(layers)
    stacked_ms += window(policy)
    plain_ms = window(layers_plain)
    l_med, s_med = statistics.median(layers_ms), statistics.median(stacked_ms)
    log(f"slice per-step ms (median of CUDA events): per-layer step "
        f"{l_med:.4f} (plain versions {statistics.median(plain_ms):.4f}) "
        f"stacked-trunk step {s_med:.4f}; actions/s per-layer "
        f"{1e3 / l_med:.1f} stacked {1e3 / s_med:.1f}")
    # where the step's time is: device busy against the step's wall time
    for label, wrapper, med in (("stacked-trunk", policy, s_med),
                                ("per-layer", layers, l_med)):
        busy, count = device_busy(lambda: wrapper.step(frames[1]), 10)
        log(f"slice {label} step profiled: device busy ms {busy:.4f}, "
            f"{count:.0f} device kernels per step, idle share "
            f"{1 - busy / med:.3f} of the {med:.4f} ms step")
    launches.update(got)
    return launches


def train_kernel_phase(device):
    """Checks and times the training kernels at the flagship's B=64."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from hypervla_tpu_torch.ops import dino_layer as dl
    from hypervla_tpu_torch.ops import dino_layer_train as dlt
    from hypervla_tpu_torch.ops import fused_attention as fa
    from hypervla_tpu_torch.ops import layer_norm as tln

    batch, seq, heads, hidden = TRAIN_BATCH, 257, 12, 768
    mlp, m = 4 * hidden, TRAIN_BATCH * 257
    scale = 1.0 / 8.0
    rng = np.random.default_rng(SEED + 2)

    def t(a, dtype=torch.bfloat16):
        return torch.tensor(np.asarray(a, np.float32), dtype=dtype,
                            device=device)

    def check(name, label, got, ref, bound, cosine=None):
        err, ref_scale = max_err(got, ref)
        limit = bound * max(ref_scale, 1.0)
        msg = (f"kernel {name} {label}: max_abs_err {err:.6g} (bound "
               f"{limit:.6g})")
        if cosine is not None:
            cos = _cosine(got, ref)
            msg += f" cosine {cos:.6f} (bound {cosine})"
            if not cos > cosine:
                raise AssertionError(f"{name} {label}: cosine {cos}")
        log(msg)
        if not err <= limit:
            raise AssertionError(f"{name} {label}: {err} > {limit}")
        return err

    table = KernelTable()
    timed = table.add

    # ---- kernel 2: the fused training attention ----
    q, k, v, g = (t(rng.standard_normal((batch, seq, hidden)))
                  for _ in range(4))
    attn_ops = 4 * batch * seq * seq * hidden  # q.k^T and P.v

    def split(a):
        return a.view(batch, seq, heads, 64).transpose(1, 2)

    o, probs = fa.mha_fused_train_fwd(q, k, v, heads, scale)
    torch.cuda.synchronize()
    ref_o, ref_p = fa.mha_fused_train_fwd_reference(q, k, v, heads, scale)
    err = max(check("mha_fused_train_fwd", "o", o, ref_o, ULP_BOUND),
              check("mha_fused_train_fwd", "P", probs, ref_p, ULP_BOUND))
    o2, p2 = fa.mha_fused_train_fwd(q, k, v, heads, scale)
    if not (torch.equal(o, o2) and torch.equal(probs, p2)):
        raise AssertionError("two runs of the attention forward differ")
    log(f"kernel mha_fused_train_fwd: two runs bit-equal; P row stride "
        f"{probs.stride(2)} values for {seq} columns")
    del o2, p2
    timed("mha_fused_train_fwd", "", err,
          lambda: fa.mha_fused_train_fwd(q, k, v, heads, scale),
          lambda: fa.mha_fused_train_fwd_reference(q, k, v, heads, scale),
          20, (nbytes(q, k, v, o, probs), attn_ops, PEAK_BF16),
          # the library call stores no P
          lambda: F.scaled_dot_product_attention(split(q), split(k),
                                                 split(v)))

    # the plain forward's P, in the row-padded layout the kernels read (the
    # forward's own layout; a dense P would be copied into it at every call)
    ref_p = fa.padded_probs(ref_p)
    grads = fa.mha_fused_train_bwd(q, k, v, ref_p, g, heads, scale)
    torch.cuda.synchronize()
    refs = fa.mha_fused_train_bwd_reference(q, k, v, ref_p, g, heads, scale)
    err = max(check("mha_fused_train_bwd", name, a, b, GRAD_BOUND)
              for name, a, b in zip(("dq", "dk", "dv"), grads, refs))
    again = fa.mha_fused_train_bwd(q, k, v, ref_p, g, heads, scale)
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise AssertionError("two runs of the attention backward differ")
    log("kernel mha_fused_train_bwd: two runs bit-equal")
    del again
    leaves = [split(a).detach().requires_grad_(True) for a in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves)
    timed("mha_fused_train_bwd", "", err,
          lambda: fa.mha_fused_train_bwd(q, k, v, ref_p, g, heads, scale),
          lambda: fa.mha_fused_train_bwd_reference(q, k, v, ref_p, g, heads,
                                                   scale),
          20, (nbytes(q, k, v, ref_p, g, q, k, v), 2 * attn_ops, PEAK_BF16),
          lambda: torch.autograd.grad(sdpa_out, leaves, split(g),
                                      retain_graph=True))
    del leaves, sdpa_out, grads, refs, o, probs, ref_o, ref_p

    # ---- kernel 3: the layer, forward without and with residuals ----
    def layer_operands():
        weights = [t(rng.standard_normal(shape) * 0.02) for shape in
                   [(hidden, hidden)] * 4 + [(hidden, mlp), (mlp, hidden)]]
        pv = t(np.concatenate([
            0.02 * rng.standard_normal((5, hidden)),
            1 + 0.1 * rng.standard_normal((1, hidden)),
            0.1 * rng.standard_normal((1, hidden)),
            1 + 0.1 * rng.standard_normal((1, hidden)),
            0.1 * rng.standard_normal((1, hidden)),
            0.1 + 0.02 * rng.standard_normal((2, hidden)),
        ]), torch.float32)
        b1 = t(0.02 * rng.standard_normal((1, mlp)), torch.float32)
        return (*weights, pv, b1, heads, 1e-6)

    x = t(rng.standard_normal((batch, seq, hidden)) * 0.5)
    layer_args = [layer_operands() for _ in range(12)]
    ops = dlt.pack_operands(*layer_args[0][:8])
    gemm_ops = 2 * m * 12 * hidden * hidden  # qkv, out-proj, fc1, fc2
    got = dlt.dino_layer_train(x, *layer_args[0])
    torch.cuda.synchronize()
    err = check("dino_layer_train_fwd", "one layer (64, 257, 768)", got,
                dlt.dino_layer_train_reference(x, *layer_args[0]),
                LAYER_BOUND)
    timed("dino_layer_train_fwd", "one layer", err,
          lambda: dlt.dino_layer_train(x, *layer_args[0]),
          lambda: dlt.dino_layer_train_reference(x, *layer_args[0]), 10,
          (nbytes(x, *ops, x), gemm_ops + attn_ops, PEAK_BF16))
    got, ref = x, x
    for args in layer_args:
        got = dlt.dino_layer_train(got, *args)
        ref = dlt.dino_layer_train_reference(ref, *args)
    torch.cuda.synchronize()
    check("dino_layer_train_fwd", "12 stacked layers", got, ref, TRUNK_BOUND)
    del got, ref, layer_args

    out, res = dlt.forward_with_residuals(x, ops, heads, 1e-6)
    torch.cuda.synchronize()
    if not torch.equal(out, dlt.dino_layer_train_packed(x, ops, heads, 1e-6)):
        raise AssertionError("the residual-saving forward and the primal "
                             "differ")
    ref_out, ref_res = dlt.forward_with_residuals_reference(x, ops, heads,
                                                            1e-6)
    err = max(check("dino_layer_train_fwd_res", name, a, b, LAYER_BOUND)
              for name, a, b in zip(("out", *dlt.RESIDUALS), (out, *res),
                                    (ref_out, *ref_res)))
    timed("dino_layer_train_fwd_res", "one layer", err,
          lambda: dlt.forward_with_residuals(x, ops, heads, 1e-6),
          lambda: dlt.forward_with_residuals_reference(x, ops, heads, 1e-6),
          10, (nbytes(x, *ops, out, *res), gemm_ops + attn_ops, PEAK_BF16))
    del ref_out, ref_res

    # ---- kernel 3: the layer backward, on the kernel forward's residuals ----
    g = t(rng.standard_normal((batch, seq, hidden)))
    names = ("dx", "dwqkv", "dwo", "dw1", "dw2", "dpv", "db1")
    got = dlt.layer_backward(g, x, ops, res, heads, 1e-6)
    torch.cuda.synchronize()
    ref = dlt.layer_backward_reference(g, x, ops, res, heads, 1e-6)
    err = max(check("dino_layer_train_bwd", name, a, b, LAYER_BOUND,
                    GRAD_COSINE_BOUND)
              for name, a, b in zip(names, got, ref))
    again = dlt.layer_backward(g, x, ops, res, heads, 1e-6)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("two runs of the layer backward differ")
    half = batch // 2
    halves = [dlt.layer_backward(g[sl], x[sl], ops, [r[sl] for r in res],
                                 heads, 1e-6)
              for sl in (slice(0, half), slice(half, batch))]
    for name, full, a, b in zip(names[1:], got[1:], *(h[1:] for h in halves)):
        full, parts = full.float(), a.float() + b.float()
        # rtol 0.05 (the JAX package's bound) with one bf16 ulp of the
        # leaf's largest value: each call rounds its own sum once
        atol = float(ULP_BOUND * full.abs().max())
        worst = float((full - parts).abs().max())
        log(f"kernel dino_layer_train_bwd {name}: batch {batch} against "
            f"two halves max_abs_diff {worst:.6g} (atol {atol:.6g} + 0.05 "
            "rel)")
        if not bool(((full - parts).abs() <= atol + 0.05 * parts.abs()
                     ).all()):
            raise AssertionError(f"{name}: batch sum differs from its halves")
    log("kernel dino_layer_train_bwd: two runs bit-equal")
    timed("dino_layer_train_bwd", "one layer", err,
          lambda: dlt.layer_backward(g, x, ops, res, heads, 1e-6),
          lambda: dlt.layer_backward_reference(g, x, ops, res, heads, 1e-6),
          10, (nbytes(g, x, *ops, *res, *got),
               2 * gemm_ops + 2 * attn_ops, PEAK_BF16))
    del again, halves, ref

    # ---- kernel 6: the training LayerNorm at the trunk's final shape ----
    rows = x.view(m, hidden)
    ln_s, ln_b = ops[5][dlt.LN1_S], ops[5][dlt.LN1_B]
    s16, b16 = ln_s.bfloat16(), ln_b.bfloat16()
    g_rows = g.view(m, hidden)
    with torch.no_grad():
        y = tln.layer_norm_pallas(x, ln_s, ln_b, 1e-6)
    torch.cuda.synchronize()
    err = check("layer_norm_pallas_fwd", "(64, 257, 768) bf16", y.view(
        m, hidden), tln.layer_norm_pallas_reference(rows, ln_s, ln_b, 1e-6),
        ULP_BOUND)

    def ln_forward():
        with torch.no_grad():
            return tln.layer_norm_pallas(x, ln_s, ln_b, 1e-6)

    timed("layer_norm_pallas_fwd", "", err, ln_forward,
          lambda: tln.layer_norm_pallas_reference(rows, ln_s, ln_b, 1e-6),
          50, (nbytes(x, x, ln_s, ln_b), 8 * x.numel(), PEAK_FP32),
          lambda: F.layer_norm(x, (hidden,), s16, b16, 1e-6))
    got = tln.layer_norm_bwd_rows(rows, g_rows, ln_s, 1e-6)
    torch.cuda.synchronize()
    ref = tln.layer_norm_bwd_rows_reference(rows, g_rows, ln_s, 1e-6)
    # dscale, dbias: fp32 sums of 16448 terms in another order
    err = max(check("layer_norm_pallas_bwd", name, a, b, bound)
              for name, a, b, bound in zip(
                  ("dx", "dscale", "dbias"), got, ref,
                  (ULP_BOUND, 1e-4, 1e-4)))
    xl = x.detach().clone().requires_grad_(True)
    sl, bl = (a.detach().clone().requires_grad_(True) for a in (s16, b16))
    ln_out = F.layer_norm(xl, (hidden,), sl, bl, 1e-6)
    timed("layer_norm_pallas_bwd", "", err,
          lambda: tln.layer_norm_bwd_rows(rows, g_rows, ln_s, 1e-6),
          lambda: tln.layer_norm_bwd_rows_reference(rows, g_rows, ln_s, 1e-6),
          50, (nbytes(x, g, ln_s, x, ln_s, ln_s), 14 * x.numel(), PEAK_FP32),
          lambda: torch.autograd.grad(ln_out, (xl, sl, bl), g,
                                      retain_graph=True))
    del xl, ln_out, y

    # ---- the launches a layer is made of, each alone at its shape ----
    # every residual but the probabilities (index 2), as rows
    x1, qkv, hc, y1, y2, ao = (r.view(m, -1)
                               for i, r in enumerate(res) if i != 2)
    wqkv, _, wo, w1, w2, pv, b1 = ops
    n1 = dl.layer_norm_rows(rows, pv[dlt.LN1_S], pv[dlt.LN1_B], 1e-6)
    hid = dl.gemm(n1, w1, b1, "gelu")
    dy = g_rows
    dbig = t(rng.standard_normal((m, mlp)) * 0.1)
    dqkv = t(rng.standard_normal((m, 3 * hidden)) * 0.1)

    def ragged_rows(label, outs, refs, bound):
        """The rows of the last, ragged row tile (M = 16448 = 128 x 128 +
        64) against the plain version, on their own."""
        first = m - m % 128
        err = max(max_err(a_[first:], b_[first:])[0]
                  for a_, b_ in zip(outs, refs))
        limit = bound * max(max(float(b_.float().abs().max())
                                for b_ in refs), 1.0)
        log(f"kernel dino_gemm_train {label}: rows {first}..{m - 1} of the "
            f"ragged last tile max_abs_err {err:.6g} (bound {limit:.6g})")
        if not err <= limit:
            raise AssertionError(f"dino_gemm_train {label}: ragged tile "
                                 f"{err} > {limit}")

    def poisoned_row_case(label, a, w, transpose_w, epilogue, with_pre):
        """The launch writes M rows and nothing past them: row M of a
        larger `out` (and second output) keeps the value put there."""
        n = w.shape[0] if transpose_w else w.shape[1]
        dtype = torch.float32 if epilogue == "f32" else torch.bfloat16
        bias = None if epilogue == "f32" else b1[:n].contiguous()
        out = torch.full((m + 1, n), 777.0, device=device, dtype=dtype)
        pre = torch.full_like(out, 777.0) if with_pre else None
        dl._launch_gemm(a, w, transpose_w, bias, None, None, out, pre, n,
                        epilogue)
        torch.cuda.synchronize()
        want = dl.gemm(a, w, bias, epilogue, transpose_w=transpose_w,
                       with_pre=with_pre)
        want = want if with_pre else (want,)
        for got, ref in zip((out, pre) if with_pre else (out,), want):
            if not (bool((got[m] == 777.0).all())
                    and torch.equal(got[:m], ref)):
                raise AssertionError(f"dino_gemm_train {label}: wrote past "
                                     "row M or changed with the buffer")
        log(f"kernel dino_gemm_train {label}: row {m} past M poisoned before "
            "the launch, untouched after it")

    def gemm_case(label, args, kw, library, f32=False):
        a, w = args[0], args[1]
        got = dl.gemm(*args, **kw)
        torch.cuda.synchronize()
        ref = dl.gemm_reference(*args, **kw)
        pairs = zip(got, ref) if isinstance(got, tuple) else [(got, ref)]
        # fp32 out: sums of K products in another order
        err = max(check("dino_gemm_train", label, a_, b_,
                        1e-4 if f32 else ULP_BOUND) for a_, b_ in pairs)
        outs = got if isinstance(got, tuple) else (got,)
        ragged_rows(label, outs, ref if isinstance(ref, tuple) else (ref,),
                    1e-4 if f32 else ULP_BOUND)
        again = dl.gemm(*args, **kw)
        again = again if isinstance(again, tuple) else (again,)
        if not all(torch.equal(a_, b_) for a_, b_ in zip(outs, again)):
            raise AssertionError(f"dino_gemm_train {label}: two runs differ")
        cfg = dl.gemm_config(a.shape[0], w.numel() // a.shape[1], a.shape[1])
        log(f"kernel dino_gemm_train {label}: two runs bit-equal; tile "
            f"{cfg.block_m}x{cfg.block_n}, split-K {cfg.split_k}")
        del again
        extra = [v for v in (*args[2:], *kw.values())
                 if isinstance(v, torch.Tensor)]
        timed("dino_gemm_train", label, err, lambda: dl.gemm(*args, **kw),
              lambda: dl.gemm_reference(*args, **kw), 10,
              (nbytes(a, w, *extra, *outs), 2 * a.shape[0] * w.numel(),
               PEAK_BF16), library)

    gemm_case("qkv [16448,768]x[768,2304]", (n1, wqkv, ops[1]), {},
              lambda: n1 @ wqkv)
    gemm_case("out-proj [16448,768]x[768,768] +residual, y1 stored",
              (ao, wo, pv[dlt.BO], "residual", rows, pv[dlt.LS1]),
              {"with_pre": True}, lambda: ao @ wo)
    gemm_case("fc1 [16448,768]x[768,3072] +gelu, hc stored",
              (n1, w1, b1, "gelu"), {"with_pre": True}, lambda: n1 @ w1)
    gemm_case("fc2 [16448,3072]x[3072,768] +residual, y2 stored",
              (hid, w2, pv[dlt.B2], "residual", x1, pv[dlt.LS2]),
              {"with_pre": True}, lambda: hid @ w2)
    gemm_case("dh [16448,768]x[3072,768]^T", (dy, w2, None),
              {"transpose_w": True}, lambda: dy @ w2.t())
    gemm_case("dao [16448,768]x[768,768]^T", (dy, wo, None),
              {"transpose_w": True}, lambda: dy @ wo.t())
    gemm_case("dn2 [16448,3072]x[768,3072]^T fp32 out", (dbig, w1, None,
                                                         "f32"),
              {"transpose_w": True}, lambda: dbig @ w1.t(), f32=True)
    gemm_case("dn1 [16448,2304]x[768,2304]^T fp32 out", (dqkv, wqkv, None,
                                                         "f32"),
              {"transpose_w": True}, lambda: dqkv @ wqkv.t(), f32=True)

    poisoned_row_case("fc1 +gelu, hc stored", n1, w1, False, "gelu", True)
    poisoned_row_case("dn2 ^T fp32 out", dbig, w1, True, "f32", False)

    def gemm_tn_case(label, a, b, time_it):
        got = dlt.gemm_tn(a, b)
        torch.cuda.synchronize()
        err = check("layer_gemm_tn", label, got, dlt.gemm_tn_reference(a, b),
                    ULP_BOUND)
        if not torch.equal(got, dlt.gemm_tn(a, b)):
            raise AssertionError(f"layer_gemm_tn {label}: two runs differ")
        rows_a, k1, n = *a.shape, b.shape[1]
        cfg = dlt.gemm_tn_config(rows_a, k1, n)
        tiles = (k1 // cfg.block_m) * (n // cfg.block_n)
        log(f"kernel layer_gemm_tn {label}: two runs bit-equal; tile "
            f"{cfg.block_m}x{cfg.block_n}, {-(-rows_a // 64)} row tiles split "
            f"{cfg.split}, grid ({tiles}, {cfg.split}) of "
            f"{dlt.gemm_tn_blocks_per_wave(cfg)} blocks a wave")
        if time_it:
            timed("layer_gemm_tn", label, err, lambda: dlt.gemm_tn(a, b),
                  lambda: dlt.gemm_tn_reference(a, b), 10,
                  (nbytes(a, b, got), 2 * rows_a * k1 * n, PEAK_BF16),
                  lambda: a.t() @ b)

    for label, a, b in (("dW2 [16448,3072]^T x [16448,768]", hid, dy),
                        ("dW1 [16448,768]^T x [16448,3072]", n1, dbig),
                        ("dWo [16448,768]^T x [16448,768]", ao, dy),
                        ("dWqkv [16448,768]^T x [16448,2304]", n1, dqkv)):
        gemm_tn_case(label, a, b, True)
    # a ragged last row tile (the rows past M are zero-filled by the copy)
    # and fewer rows than two row tiles (the 64 x 64 tile, no split)
    more = t(rng.standard_normal((37, mlp)))
    gemm_tn_case("ragged dW1 [16485,768]^T x [16485,3072]",
                 torch.cat([n1, more[:, :hidden]]),
                 torch.cat([dbig, more * 0.1]), False)
    gemm_tn_case("ragged dWo [16485,768]^T x [16485,768]",
                 torch.cat([ao, more[:, :hidden]]),
                 torch.cat([dy, more[:, hidden:2 * hidden]]), False)
    gemm_tn_case("dWo [99,768]^T x [99,768]", ao[:99].contiguous(),
                 dy[:99].contiguous(), False)
    del more

    def pass_case(name, label, kern, plain, args, bounds, ops_per_elt,
                  library=None):
        got = kern(*args)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        ref = plain(*args)
        ref = ref if isinstance(ref, tuple) else (ref,)
        err = max(check(name, f"{label} output {i}", a_, b_, bound)
                  for i, (a_, b_, bound) in enumerate(zip(got, ref, bounds)))
        tensors = [v for v in args if isinstance(v, torch.Tensor)]
        timed(name, label, err, lambda: kern(*args), lambda: plain(*args),
              20, (nbytes(*tensors, *got), ops_per_elt * args[0].numel(),
                   PEAK_FP32), library)

    dn = t(rng.standard_normal((m, hidden)) * 0.1, torch.float32)
    # fp32 column sums: 16448 terms in another order, and one-ulp flips of
    # single bf16 terms
    pass_case("layer_norm_bwd_rows", "(16448, 768), fp32 cotangent, added "
              "to the residual gradient", tln.layer_norm_bwd_rows,
              tln.layer_norm_bwd_rows_reference,
              (rows, dn, pv[dlt.LN2_S], 1e-6, g_rows),
              (ULP_BOUND, 1e-4, 1e-4), 14)
    pass_case("layer_scale_grad", "(16448, 768)", dlt.scale_grad,
              dlt.scale_grad_reference, (g_rows, y2, pv[dlt.LS2]),
              (ULP_BOUND, 1e-4, 2 ** -9), 4)
    pass_case("layer_gelu_bwd", "(16448, 3072)", dlt.gelu_bwd,
              dlt.gelu_bwd_reference, (hc, dbig),
              (ULP_BOUND, ULP_BOUND, 2 ** -9), 30)
    pass_case("layer_colsum", "(16448, 2304)", dlt.colsum,
              dlt.colsum_reference, (dqkv,), (1e-4,), 1,
              lambda: dqkv.sum(0, dtype=torch.float32))

    return table.log_rows(f" at B={batch}, per layer")


def _cosine(a, b):
    a, b = a.detach().double().flatten(), b.detach().double().flatten()
    n = float(a.norm() * b.norm())
    if n == 0.0:
        return 1.0 if float((a - b).abs().max()) == 0.0 else 0.0
    return float(a @ b) / n


@contextlib.contextmanager
def fused_gelu_env(on):
    """HYPERVLA_FUSED_GELU=1 inside the block if `on`, restored after."""
    old = os.environ.get("HYPERVLA_FUSED_GELU")
    if on:
        os.environ["HYPERVLA_FUSED_GELU"] = "1"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("HYPERVLA_FUSED_GELU", None)
        else:
            os.environ["HYPERVLA_FUSED_GELU"] = old


def train_phase(device):
    """Drives the full-width flagship's training step through the entry
    points of scripts/bench_train.py under three kernel configurations (the
    fast preset; the fast preset with the layer-kernel trunk; the fast
    preset with the fused residual boundaries and the fused GELU) and on
    the plain path. Returns each kernel configuration's launches."""
    import copy

    import torch

    from hypervla_tpu_torch.configs import apply_fast_training_preset
    from hypervla_tpu_torch.flagship import build_flagship, make_flagship_batch
    from hypervla_tpu_torch.models.base_network import BaseNetwork
    from hypervla_tpu_torch.models.hypervla import HyperVLA
    from hypervla_tpu_torch.ops import add_layer_norm as aln
    from hypervla_tpu_torch.ops import dino_layer as dl
    from hypervla_tpu_torch.ops import dino_layer_train as dlt
    from hypervla_tpu_torch.ops import fused_attention as fa
    from hypervla_tpu_torch.ops import gelu as tg
    from hypervla_tpu_torch.ops import layer_norm as tln
    from hypervla_tpu_torch.train.optimizer import (
        create_optimizer,
        hn_param_type_tree,
    )
    from hypervla_tpu_torch.train.train_state import TrainState
    from hypervla_tpu_torch.train.train_step import make_train_step, to_tensors
    from hypervla_tpu_torch.train.trainer import build_frozen_encoders

    t0 = time.perf_counter()
    model, _ = build_flagship(seed=SEED, device=device, training=True)
    fast = apply_fast_training_preset(copy.deepcopy(model.config))
    model = HyperVLA.from_config(fast, make_flagship_batch(seed=SEED),
                                 seed=SEED, device=device)
    # the layer-kernel trunk: every trunk layer through the layer kernel,
    # forward with residuals and backward; the final LayerNorm of both
    # encoders through the training LayerNorm
    layer = copy.deepcopy(fast)
    layer["hoist_shared_trunk"] = True
    layer["base_net_kwargs"]["vit_kwargs"].update(
        dino_layers_impl="pallas_train", fused_layer_norm="pallas_train",
        fine_tune_pretrained_image_encoder=True)
    # the fused residual boundaries: every LayerScale multiply, residual add
    # and the LayerNorm after it as one kernel, forward and backward; with
    # HYPERVLA_FUSED_GELU=1 during its steps, the trunk's GELU forward too
    fused = copy.deepcopy(fast)
    fused["base_net_kwargs"]["vit_kwargs"]["dino_fused_add_ln"] = True
    # the plain path: the fast preset's step with the kernel switches off
    plain = copy.deepcopy(fast)
    plain["base_net_kwargs"]["vit_kwargs"]["dino_fused_attention"] = False
    plain["frozen_encoder_layer_kernel"] = False
    configs = {"plain": plain, "fast_preset": fast, "layer_kernel": layer,
               "fused_add_ln": fused}
    kernel_configs = ("fast_preset", "layer_kernel", "fused_add_ln")

    tx, lr_fn, base_lr_fn, pnorm_fn = create_optimizer(
        model.params, hn_param_type_tree(model.params), **fast["optimizer"])
    state0 = TrainState.create(model.params, tx,
                               track_ema=fast.get("save_param_EMA", True))
    # the LR at its peak: the schedules read the optimizer's update count
    warmup = fast["optimizer"]["learning_rate"]["warmup_steps"]
    state0.step = warmup
    state0.opt_state["count"] = warmup
    steps, encoders, dino_applies = {}, {}, {}
    t5_params = None
    for name, config in configs.items():
        variant = model if config is fast else HyperVLA(
            model.hypernet, BaseNetwork(**config["base_net_kwargs"]), config,
            model.params, model.plan, None, device)
        # the same draws for every configuration; the frozen DINOv2's layers
        # packed for the layer forward, or left for the plain loop
        text_apply, dino_apply, t5, dino_params = build_frozen_encoders(
            config, device=device, seed=SEED + 1)
        t5_params = t5_params if t5_params is not None else t5
        del t5
        steps[name] = make_train_step(variant, config, tx, lr_fn, base_lr_fn,
                                      pnorm_fn, text_encode=text_apply,
                                      dino_encode=dino_apply)
        encoders[name] = {"t5": t5_params, "dino": dino_params}
        dino_applies[name] = dino_apply
    batch = make_flagship_batch(batch_size=TRAIN_BATCH, seed=SEED)
    # the step embeds the instruction and the initial image itself
    del batch["task"]["language_instruction"]["token_embedding"]
    del batch["initial_state"]["patch_embeddings"]
    batch = to_tensors(batch, device)
    n_params = sum(v.numel() for v in model.params.values())
    torch.cuda.synchronize()
    log(f"train build s {time.perf_counter() - t0:.3f}; {n_params} trained "
        f"params, batch {TRAIN_BATCH}, lr {lr_fn(warmup):.6g}")

    layers = model.base_net.encoder.dino.num_hidden_layers
    # launches per step of each wrapper that a configuration must show
    per_step = {
        "plain": {},
        "fast_preset": {"mha_fused_train_fwd": layers,
                        "mha_fused_train_bwd": layers,
                        "dino_layer_train_fwd": layers},
        "layer_kernel": {"dino_layer_train_fwd_res": layers,
                         "dino_layer_train_bwd": layers,
                         "dino_layer_train_fwd": layers,
                         "layer_norm_pallas_fwd": 2,
                         "layer_norm_pallas_bwd": 1},
        # every residual boundary but the last, forward and backward; one
        # GELU per trunk layer (the frozen encoder's is the GEMM epilogue)
        "fused_add_ln": {"mha_fused_train_fwd": layers,
                         "mha_fused_train_bwd": layers,
                         "dino_layer_train_fwd": layers,
                         "fused_add_scale_ln_fwd": 2 * layers - 1,
                         "fused_add_scale_ln_bwd": 2 * layers - 1,
                         "gelu_exact_fused": layers},
    }
    counted = sorted(set().union(*per_step.values()))
    counting = (fa, dlt, tln, dl, aln, tg)

    def counts():
        return {**fa.LAUNCHES, **dlt.LAUNCHES, **tln.LAUNCHES,
                **aln.LAUNCHES, **tg.LAUNCHES,
                "dino_gemm_train": dl.LAUNCHES["dino_gemm"]}

    totals = {name: dict.fromkeys(counts(), 0) for name in configs}
    infos = {name: [] for name in configs}
    peaks = dict.fromkeys(configs, 0)

    def run(name, state, n, with_metrics=False):
        """n steps of one configuration from state, its launches counted
        from zero; (state, per-step device ms)."""
        for module in counting:
            module.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(n):
            before = counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            with fused_gelu_env(name == "fused_add_ln"):
                state, info = steps[name](state, batch,
                                          encoder_params=encoders[name],
                                          with_metrics=with_metrics)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            infos[name].append(info)
            after = counts()
            got = {k: after[k] - before[k] for k in counted}
            want = {k: per_step[name].get(k, 0) for k in counted}
            if got != want:
                raise AssertionError(f"{name} step launches {got}, want "
                                     f"{want}")
        for k, v in counts().items():
            totals[name][k] += v
        peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated())
        return state, times

    # the main paths, counted: every launch below is a training step's
    states = {name: run(name, state0, 1, True)[0] for name in configs}
    first_p = infos["plain"][0]

    def updates_of(name):
        return {k: states[name].params[k].detach() - v.detach()
                for k, v in state0.params.items()}

    plain_updates = updates_of("plain")
    typical = statistics.median(float(p.norm())
                                for p in plain_updates.values())
    # the update (new - old) per leaf: Adam's first step is ~lr * sign(g),
    # so this compares the two paths' gradients leaf by leaf. A leaf whose
    # exact gradient is 0 barely moves: the context encoder's (the output
    # heads start at zero, so the generated weights do not depend on it yet)
    # and the key biases (softmax ignores a uniform key shift). On such a
    # leaf the kernels must move as little (tests/test_torch_train_step.py
    # holds the port to JAX by the same rule)
    degenerate = [k for k, p in plain_updates.items()
                  if float(p.norm()) < 1e-3 * typical]
    for name in kernel_configs:
        first_k = infos[name][0]
        for key in ("training_loss", "grad_norm"):
            a, b = float(first_k[key]), float(first_p[key])
            log(f"train {name} first step {key}: kernels {a:.6g} plain "
                f"{b:.6g} (rel {abs(a - b) / abs(b):.3g}, bound "
                f"{STEP_REL_BOUND})")
            if not abs(a - b) <= STEP_REL_BOUND * abs(b):
                raise AssertionError(f"{name}: first-step {key} kernels vs "
                                     "plain")
        updates = updates_of(name)
        worst = min((_cosine(updates[k], plain_updates[k]), k)
                    for k in updates if k not in degenerate)
        log(f"train {name} first step updates, kernels vs plain: lowest "
            f"per-leaf cosine {worst[0]:.6f} ({worst[1]}), bound "
            f"{COSINE_BOUND}; {len(degenerate)} leaves barely move (update "
            "below 1e-3 of the median leaf's)")
        if not worst[0] > COSINE_BOUND:
            raise AssertionError(f"{name}: the updates disagree with the "
                                 "plain path")
        for k in degenerate:
            if not float(updates[k].norm()) < 1e-2 * typical:
                raise AssertionError(f"{name} {k}: the plain path leaves it "
                                     "at noise")
        # and the post-update params themselves
        worst = min((_cosine(states[name].params[k],
                             states["plain"].params[k]), k)
                    for k in updates if k not in degenerate)
        log(f"train {name} first step post-update params, kernels vs "
            f"plain: lowest per-leaf cosine {worst[0]:.6f} ({worst[1]}), "
            f"bound {COSINE_BOUND}")
        if not worst[0] > COSINE_BOUND:
            raise AssertionError(f"{name}: post-update params disagree with "
                                 "the plain path")
        # fp32 copies of the trained params: not to be counted in the peak
        del updates
    log(f"train leaves that barely move: {sorted(degenerate)}")
    del plain_updates

    for name in configs:
        states[name], _ = run(name, states[name], TRAIN_WARMUP - 1)
    # timed steps, in turns: plain, kernels, kernels, plain
    half = TRAIN_STEPS // 2
    times = {name: [] for name in configs}
    for name in ("plain", *kernel_configs, *reversed(kernel_configs),
                 "plain"):
        states[name], more = run(name, states[name], half)
        times[name] += more
    for name in kernel_configs:
        log(f"train {name} launches over {len(infos[name])} steps: "
            f"{ {k: v for k, v in totals[name].items() if v} }")

    # the frozen DINOv2 encode of the initial images alone, in turns
    images = batch["initial_state"]["image_primary"].squeeze(1)

    def encode_ms(name, n=5):
        out = []
        with torch.no_grad():
            for _ in range(n):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                dino_applies[name](encoders[name]["dino"], images)
                end.record()
                end.synchronize()
                out.append(start.elapsed_time(end))
        return out

    enc = {name: [] for name in configs}
    for name in ("plain", *kernel_configs, *reversed(kernel_configs),
                 "plain"):
        enc[name] += encode_ms(name)
    log(f"train frozen DINOv2 encode of {TRAIN_BATCH} images ms (median of "
        "CUDA events): " + ", ".join(
            f"{name} {statistics.median(v):.4f}" for name, v in enc.items()))

    for name in kernel_configs:
        losses = [float(info["training_loss"]) for info in infos[name]]
        log(f"train {name} losses: {[round(x, 4) for x in losses]}")
        if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"{name}: train loss not finite or not "
                                 "falling")
    for name in configs:
        med = statistics.median(times[name])
        log(f"train {name} ms/step (median of CUDA events, {TRAIN_STEPS} "
            f"steps): {med:.4f}; samples/s {TRAIN_BATCH * 1e3 / med:.1f}; "
            f"peak memory (max_memory_allocated) "
            f"{peaks[name] / 2 ** 30:.3f} GiB")
    # where the step's time is: one profiled step of each configuration,
    # its device busy time against the unprofiled median above
    for name in configs:
        def one_step(name=name):
            with fused_gelu_env(name == "fused_add_ln"):
                steps[name](states[name], batch,
                            encoder_params=encoders[name], with_metrics=False)

        busy, count = device_busy(one_step)
        med = statistics.median(times[name])
        log(f"train {name} step profiled: device busy ms {busy:.3f}, "
            f"{count:.0f} device kernels, idle share {1 - busy / med:.3f} "
            f"of the {med:.4f} ms step")
    return {name: totals[name] for name in kernel_configs}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    # fp32 matmuls in full fp32 on the card (the plain versions' reference)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    device = torch.device("cuda", 0)

    from hypervla_tpu_torch.utils import cuda_build

    # one nvcc per source, all started together, so the build time stays
    # that of the slowest source as sources are added
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        list(pool.map(cuda_build.build, SOURCES))
    log(f"build: {', '.join(SOURCES)} in {time.perf_counter() - t0:.2f} s "
        "(one nvcc each, in parallel)")

    results = kernel_phase(device)
    launches = slice_phase(device)
    row_results, add_ln_launches = row_flash_kernel_phase(device)
    train_results = train_kernel_phase(device)
    train_launches = train_phase(device)

    # the configuration whose steps launch each training kernel
    path_of = dict.fromkeys(TRAIN_KERNELS, "layer_kernel")
    path_of.update(mha_fused_train_fwd="fast_preset",
                   mha_fused_train_bwd="fast_preset",
                   dino_layer_train_fwd="fast_preset")
    kernels = [
        {"name": name, "route": "cuda", "source": TRUNK_SOURCE,
         "replaces": TPU_KERNEL, "launches": launches[name], **r}
        for name, r in results.items()
    ] + [
        {"name": name, "route": "cuda", "source": TRAIN_KERNELS[name][0],
         "replaces": TRAIN_KERNELS[name][1],
         "launches": train_launches[path_of[name]][name], **r}
        for name, r in train_results.items()
    ]
    # the kernels of the per-layer serving step and of the fused-add-LN train
    # step; fused_add_ln (no LayerScale) lies on no model path of either
    # package, so its launches are those of its own function, driven and
    # counted in the row kernel phase; flash_attention_b64 is the serving
    # kernel at another shape (logged)
    row_launches = {**train_launches["fused_add_ln"], **add_ln_launches,
                    **launches}
    for name, (source, replaces) in ROW_FLASH_KERNELS.items():
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": row_launches[name],
                        **row_results[name]})
    for kernel in kernels:
        if kernel["launches"] == 0:
            raise AssertionError(f"{kernel['name']} was not launched on its "
                                 "main path")
    log("kernels ms/device_ms/plain_ms/library_ms/bound_ms: per flagship "
        "layer for "
        "the serving kernels (2 LayerNorms, 4 GEMMs, 1 attention), per "
        "12-layer trunk for dino_layers_serving, per launch at B=64 for the "
        "training kernels, where dino_gemm_train and layer_gemm_tn add up "
        "one layer's launches (8 and 4 shapes); launches: over the serving "
        "steps for the first four, over the fast preset's train steps for "
        "mha_fused_train_* and dino_layer_train_fwd (mha_fused_train_fwd "
        "counts the trunk's attention forward; a layer call also launches "
        "the attention kernels, counted under the layer), over the "
        "layer-kernel trunk's train steps for the other training kernels; "
        "flash_attention and layer_norm per launch at the serving shapes, "
        "launches over the per-layer serving steps; fused_add_scale_ln_* "
        "and gelu_exact_fused per launch at B=64, launches over the "
        "fused-add-LN train steps; fused_add_ln_* per launch at B=64, "
        "launches of one counted call of the differentiable function, "
        "forward and backward (it lies on no model path)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
