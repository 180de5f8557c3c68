#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the port's CUDA kernels (hypervla_tpu_torch/csrc) with nvcc.
2. Kernel phase: runs each kernel of the DINOv2 serving trunk, and the
   12-layer trunk, at the flagship's shapes (seq 257, width 768) against its
   plain PyTorch version on the same inputs, and times both.
3. Slice phase: builds the full-width flagship from a seed, encodes an
   initial frame with the fp32 DINOv2, resets an InferenceWrapper with a
   random (1, 32, 768) instruction embedding and drives ~50 fused serving
   steps on random 256x256 frames (crop and ensembling on). Checks that every
   step went through the trunk kernels and that the actions match the same
   steps run with the plain trunk.

Prints the card's name and power limit, the per-phase results, a
{"kernels": [...]} JSON line, and as its last line
{"ok": true, "device": {...}}. Any failed check raises and exits non-zero
without that line. Needs a CUDA device: exits non-zero without one.
"""
import json
import statistics
import subprocess
import sys
import time

STEPS = 50
SEED = 0
TRUNK_SOURCE = "hypervla_tpu_torch/csrc/dino_layer.cu"
TPU_KERNEL = "hypervla_tpu/ops/dino_layer.py:87"  # `_kernel`, the Pallas body
# kernel-vs-plain bounds: one bf16 ulp of the output scale for one kernel
# launch; the bounds the JAX package holds between its own trunks for the
# 12-layer trunk and for the actions
ULP_BOUND = 2 ** -7
TRUNK_BOUND = 0.05


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

    # one layer's launches of each kernel, as the trunk makes them
    cases = {
        "dino_layer_norm": [
            ("ln1", dl.layer_norm_rows, dl.layer_norm_rows_reference,
             (x, p[0, dl.LN1_S], p[0, dl.LN1_B], 1e-6), {}),
            ("ln2", dl.layer_norm_rows, dl.layer_norm_rows_reference,
             (x, p[0, dl.LN2_S], p[0, dl.LN2_B], 1e-6), {}),
        ],
        "dino_gemm": [
            ("qkv [257,768]x[768,2304]", dl.gemm, dl.gemm_reference,
             (x, w[0, 0, :, :3 * hd], b[0, 0, :3 * hd]), {}),
            ("out-proj [257,768]x[768,768] +residual", dl.gemm,
             dl.gemm_reference, (x, w[0, 0, :, 3 * hd:], b[0, 0, 3 * hd:],
                                 "residual", x, p[0, dl.LS1]), {}),
            ("fc1 [257,768]x[768,3072] +gelu", dl.gemm, dl.gemm_reference,
             (x, w[0, 1], b[0, 1], "gelu"), {}),
            ("fc2 [257,3072]x[768,3072]^T +residual", dl.gemm,
             dl.gemm_reference, (h_in, w[0, 2], b[0, 2, :hd], "residual", x,
                                 p[0, dl.LS2], True), {}),
        ],
        "dino_attention": [
            ("12 heads x 257 tokens", dl.attention, dl.attention_reference,
             (qkv,), {}),
        ],
    }
    results = {}
    for name, calls in cases.items():
        err_all, ms, plain_ms = 0.0, 0.0, 0.0
        for label, kern, plain, args, kw in calls:
            got = kern(*args, **kw)
            torch.cuda.synchronize()
            err, scale = max_err(got, plain(*args, **kw))
            bound = ULP_BOUND * max(scale, 1.0)
            k_ms, p_ms = interleaved(lambda: kern(*args, **kw),
                                     lambda: plain(*args, **kw), 200)
            log(f"kernel {name} {label}: max_abs_err {err:.6g} "
                f"(bound {bound:.6g}) ms {k_ms:.6g} plain_ms {p_ms:.6g}")
            if not err <= bound:
                raise AssertionError(f"{name} {label}: {err} > {bound}")
            err_all = max(err_all, err)
            ms += k_ms
            plain_ms += p_ms
        results[name] = {"max_abs_err": err_all, "ms": ms,
                         "plain_ms": plain_ms}

    got = dl.dino_layers_serving(x, w, b, p)
    torch.cuda.synchronize()
    err, scale = max_err(got, dl.dino_layers_serving_reference(x, w, b, p))
    bound = TRUNK_BOUND * max(scale, 1.0)
    k_ms, p_ms = interleaved(lambda: dl.dino_layers_serving(x, w, b, p),
                             lambda: dl.dino_layers_serving_reference(
                                 x, w, b, p), 20)
    log(f"kernel dino_layers_serving 12 layers: max_abs_err {err:.6g} "
        f"(bound {bound:.6g}) ms {k_ms:.6g} plain_ms {p_ms:.6g}")
    if not err < bound:
        raise AssertionError(f"12-layer trunk: {err} >= {bound}")
    results["dino_layers_serving"] = {"max_abs_err": err, "ms": k_ms,
                                      "plain_ms": p_ms}
    weight_bytes = w.numel() * 2
    log(f"trunk weights {weight_bytes / 1e6:.1f} MB; kernel trunk reads them "
        f"at {weight_bytes / (k_ms * 1e-3) / 1e9:.1f} GB/s effective")
    return results


def make_wrapper(model, trunk_impl):
    from hypervla_tpu_torch.eval.inference import InferenceWrapper

    return InferenceWrapper(model, policy_setup="google_robot",
                            image_size=224, action_ensemble=True, crop=True,
                            trunk_impl=trunk_impl)


def slice_phase(device):
    """Drives the full-width flagship through the serving entry points."""
    import numpy as np
    import torch

    from hypervla_tpu_torch.eval.inference import initial_state
    from hypervla_tpu_torch.flagship import build_flagship
    from hypervla_tpu_torch.ops import dino_layer as dl

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
    return launches


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

    t0 = time.perf_counter()
    cuda_build.load_library("dino_layer.cu")
    log(f"build: dino_layer.cu in {time.perf_counter() - t0:.2f} s")

    results = kernel_phase(device)
    launches = slice_phase(device)

    kernels = [
        {"name": name, "route": "cuda", "source": TRUNK_SOURCE,
         "replaces": TPU_KERNEL, "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"]}
        for name, r in results.items()
    ]
    log("kernels ms/plain_ms: per flagship layer for the three kernels "
        "(2 LayerNorms, 4 GEMMs, 1 attention), per 12-layer trunk for "
        "dino_layers_serving")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
