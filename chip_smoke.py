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
   steps run with the plain trunk.
4. Training kernel phase: the fused training attention forward and
   backward at B=64, S=257, H=12, D=64 and the no-residual layer forward at
   (64, 257, 768), one layer and 12 stacked, against their plain versions;
   both timed.
5. Train phase: the full-width flagship under the fast training preset at
   batch 64 through the entry points of scripts/bench_train.py --fast, the
   frozen T5 and DINOv2 drawn from seeds, the LR at its peak: 2 warm-up and
   8 steps on one fixed batch. Checks every step's launches, a finite and
   falling loss, and the first step against the plain path (the same step
   with dino_fused_attention and frozen_encoder_layer_kernel off); times
   both in turns.

Prints the card's name and power limit, the per-phase results, a
{"kernels": [...]} JSON line, and as its last line
{"ok": true, "device": {...}}. Any failed check raises and exits non-zero
without that line. Needs a CUDA device: exits non-zero without one.
"""
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

STEPS = 50
SEED = 0
SOURCES = ("dino_layer.cu", "fused_attention.cu")
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
}
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
TRAIN_WARMUP, TRAIN_STEPS = 2, 8
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


def train_kernel_phase(device):
    """Checks and times the training kernels at the flagship's B=64."""
    import numpy as np
    import torch

    from hypervla_tpu_torch.ops import dino_layer_train as dlt
    from hypervla_tpu_torch.ops import fused_attention as fa

    batch, seq, heads, hidden = TRAIN_BATCH, 257, 12, 768
    scale = 1.0 / 8.0
    rng = np.random.default_rng(SEED + 2)

    def t(a, dtype=torch.bfloat16):
        return torch.tensor(np.asarray(a, np.float32), dtype=dtype,
                            device=device)

    q, k, v, g = (t(rng.standard_normal((batch, seq, hidden)))
                  for _ in range(4))
    results = {}

    def check(name, label, got, ref, bound):
        err, ref_scale = max_err(got, ref)
        limit = bound * max(ref_scale, 1.0)
        log(f"kernel {name} {label}: max_abs_err {err:.6g} (bound "
            f"{limit:.6g})")
        if not err <= limit:
            raise AssertionError(f"{name} {label}: {err} > {limit}")
        return err

    o, probs = fa.mha_fused_train_fwd(q, k, v, heads, scale)
    torch.cuda.synchronize()
    ref_o, ref_p = fa.mha_fused_train_fwd_reference(q, k, v, heads, scale)
    err = max(check("mha_fused_train_fwd", "o", o, ref_o, ULP_BOUND),
              check("mha_fused_train_fwd", "P", probs, ref_p, ULP_BOUND))
    k_ms, p_ms = interleaved(
        lambda: fa.mha_fused_train_fwd(q, k, v, heads, scale),
        lambda: fa.mha_fused_train_fwd_reference(q, k, v, heads, scale), 20)
    results["mha_fused_train_fwd"] = {"max_abs_err": err, "ms": k_ms,
                                      "plain_ms": p_ms}

    grads = fa.mha_fused_train_bwd(q, k, v, ref_p, g, heads, scale)
    torch.cuda.synchronize()
    refs = fa.mha_fused_train_bwd_reference(q, k, v, ref_p, g, heads, scale)
    err = max(check("mha_fused_train_bwd", name, a, b, GRAD_BOUND)
              for name, a, b in zip(("dq", "dk", "dv"), grads, refs))
    k_ms, p_ms = interleaved(
        lambda: fa.mha_fused_train_bwd(q, k, v, ref_p, g, heads, scale),
        lambda: fa.mha_fused_train_bwd_reference(q, k, v, ref_p, g, heads,
                                                 scale), 20)
    results["mha_fused_train_bwd"] = {"max_abs_err": err, "ms": k_ms,
                                      "plain_ms": p_ms}

    def layer_operands():
        weights = [t(rng.standard_normal(shape) * 0.02) for shape in
                   [(hidden, hidden)] * 4 + [(hidden, 4 * hidden),
                                             (4 * hidden, hidden)]]
        pv = t(np.concatenate([
            0.02 * rng.standard_normal((5, hidden)),
            1 + 0.1 * rng.standard_normal((1, hidden)),
            0.1 * rng.standard_normal((1, hidden)),
            1 + 0.1 * rng.standard_normal((1, hidden)),
            0.1 * rng.standard_normal((1, hidden)),
            0.1 + 0.02 * rng.standard_normal((2, hidden)),
        ]), torch.float32)
        b1 = t(0.02 * rng.standard_normal((1, 4 * hidden)), torch.float32)
        return (*weights, pv, b1, heads, 1e-6)

    x = t(rng.standard_normal((batch, seq, hidden)) * 0.5)
    ops = [layer_operands() for _ in range(12)]
    got = dlt.dino_layer_train(x, *ops[0])
    torch.cuda.synchronize()
    err = check("dino_layer_train_fwd", "one layer (64, 257, 768)", got,
                dlt.dino_layer_train_reference(x, *ops[0]), LAYER_BOUND)
    k_ms, p_ms = interleaved(
        lambda: dlt.dino_layer_train(x, *ops[0]),
        lambda: dlt.dino_layer_train_reference(x, *ops[0]), 10)
    results["dino_layer_train_fwd"] = {"max_abs_err": err, "ms": k_ms,
                                       "plain_ms": p_ms}
    got, ref = x, x
    for args in ops:
        got = dlt.dino_layer_train(got, *args)
        ref = dlt.dino_layer_train_reference(ref, *args)
    torch.cuda.synchronize()
    check("dino_layer_train_fwd", "12 stacked layers", got, ref, TRUNK_BOUND)
    for name, r in results.items():
        log(f"kernel {name} at B={batch}: ms {r['ms']:.6g} plain_ms "
            f"{r['plain_ms']:.6g}")
    return results


def _cosine(a, b):
    a, b = a.detach().double().flatten(), b.detach().double().flatten()
    n = float(a.norm() * b.norm())
    if n == 0.0:
        return 1.0 if float((a - b).abs().max()) == 0.0 else 0.0
    return float(a @ b) / n


def train_phase(device):
    """Drives the full-width flagship's training step under the fast preset
    through the entry points of scripts/bench_train.py --fast."""
    import copy

    import torch

    from hypervla_tpu_torch.configs import apply_fast_training_preset
    from hypervla_tpu_torch.flagship import build_flagship, make_flagship_batch
    from hypervla_tpu_torch.models.base_network import BaseNetwork
    from hypervla_tpu_torch.models.hypervla import HyperVLA
    from hypervla_tpu_torch.ops import dino_layer_train as dlt
    from hypervla_tpu_torch.ops import fused_attention as fa
    from hypervla_tpu_torch.train.optimizer import (
        create_optimizer,
        hn_param_type_tree,
    )
    from hypervla_tpu_torch.train.train_state import TrainState
    from hypervla_tpu_torch.train.train_step import make_train_step, to_tensors
    from hypervla_tpu_torch.train.trainer import build_frozen_encoders

    t0 = time.perf_counter()
    model, _ = build_flagship(seed=SEED, device=device, training=True)
    config = apply_fast_training_preset(copy.deepcopy(model.config))
    model = HyperVLA.from_config(config, make_flagship_batch(seed=SEED),
                                 seed=SEED, device=device)
    text_apply, dino_apply, t5_params, dino_params = build_frozen_encoders(
        config, device=device, seed=SEED + 1)
    tx, lr_fn, base_lr_fn, pnorm_fn = create_optimizer(
        model.params, hn_param_type_tree(model.params), **config["optimizer"])
    state0 = TrainState.create(model.params, tx,
                               track_ema=config.get("save_param_EMA", True))
    # the LR at its peak: the schedules read the optimizer's update count
    warmup = config["optimizer"]["learning_rate"]["warmup_steps"]
    state0.step = warmup
    state0.opt_state["count"] = warmup
    step_kernel = make_train_step(model, config, tx, lr_fn, base_lr_fn,
                                  pnorm_fn, text_encode=text_apply,
                                  dino_encode=dino_apply)
    # the plain path: the same step with the two kernel switches off
    plain_config = copy.deepcopy(config)
    plain_config["base_net_kwargs"]["vit_kwargs"]["dino_fused_attention"] = (
        False)
    plain_config["frozen_encoder_layer_kernel"] = False
    plain_model = HyperVLA(model.hypernet,
                           BaseNetwork(**plain_config["base_net_kwargs"]),
                           plain_config, model.params, model.plan, None,
                           device)
    # the same frozen DINOv2 draw, unpacked: its layers take the plain loop
    _, plain_dino_apply, _, plain_dino_params = build_frozen_encoders(
        plain_config, device=device, seed=SEED + 1)
    step_plain = make_train_step(plain_model, plain_config, tx, lr_fn,
                                 base_lr_fn, pnorm_fn,
                                 text_encode=text_apply,
                                 dino_encode=plain_dino_apply)
    batch = make_flagship_batch(batch_size=TRAIN_BATCH, seed=SEED)
    # the step embeds the instruction and the initial image itself
    del batch["task"]["language_instruction"]["token_embedding"]
    del batch["initial_state"]["patch_embeddings"]
    batch = to_tensors(batch, device)
    enc_kernel = {"t5": t5_params, "dino": dino_params}
    enc_plain = {"t5": t5_params, "dino": plain_dino_params}
    n_params = sum(v.numel() for v in model.params.values())
    torch.cuda.synchronize()
    log(f"train build s {time.perf_counter() - t0:.3f}; {n_params} trained "
        f"params, batch {TRAIN_BATCH}, lr {lr_fn(warmup):.6g}")

    counted = ("mha_fused_train_fwd", "mha_fused_train_bwd",
               "dino_layer_train_fwd")
    layers = model.base_net.encoder.dino.num_hidden_layers

    def counts():
        return {**fa.LAUNCHES, **dlt.LAUNCHES}

    def run(step_fn, state, n, kernel, with_metrics=False):
        """n steps from state; (state, infos, per-step device ms)."""
        infos, times = [], []
        for _ in range(n):
            before = counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, info = step_fn(
                state, batch, encoder_params=enc_kernel if kernel else
                enc_plain, with_metrics=with_metrics)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            infos.append(info)
            after = counts()
            per_step = {k: after[k] - before[k] for k in counted}
            want = layers if kernel else 0
            if any(v != want for v in per_step.values()):
                raise AssertionError(f"step launches {per_step}, want "
                                     f"{want} of each")
        return state, infos, times

    # the main path, counted: every launch below is a training step's
    fa.reset_launch_counts()
    dlt.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    state_k, infos_k, _ = run(step_kernel, state0, 1, True, True)
    peak_k = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state_p, infos_p, _ = run(step_plain, state0, 1, False, True)
    peak_p = torch.cuda.max_memory_allocated()
    first_k, first_p = infos_k[0], infos_p[0]
    for key in ("training_loss", "grad_norm"):
        a, b = float(first_k[key]), float(first_p[key])
        log(f"train first step {key}: kernels {a:.6g} plain {b:.6g} "
            f"(rel {abs(a - b) / abs(b):.3g}, bound {STEP_REL_BOUND})")
        if not abs(a - b) <= STEP_REL_BOUND * abs(b):
            raise AssertionError(f"first-step {key} kernels vs plain")
    # the update (new - old) per leaf: Adam's first step is ~lr * sign(g),
    # so this compares the two paths' gradients leaf by leaf. A leaf whose
    # exact gradient is 0 barely moves: the context encoder's (the output
    # heads start at zero, so the generated weights do not depend on it yet)
    # and the key biases (softmax ignores a uniform key shift). On such a
    # leaf the kernels must move as little (tests/test_torch_train_step.py
    # holds the port to JAX by the same rule)
    updates = {k: (state_k.params[k].detach() - v.detach(),
                   state_p.params[k].detach() - v.detach())
               for k, v in state0.params.items()}
    typical = statistics.median(float(p.norm()) for _, p in updates.values())
    degenerate = [k for k, (_, p) in updates.items()
                  if float(p.norm()) < 1e-3 * typical]
    worst = min((_cosine(*updates[k]), k) for k in updates
                if k not in degenerate)
    log(f"train first step updates, kernels vs plain: lowest per-leaf "
        f"cosine {worst[0]:.6f} ({worst[1]}), bound {COSINE_BOUND}; "
        f"{len(degenerate)} leaves barely move (update below 1e-3 of the "
        f"median leaf's): {sorted(degenerate)}")
    if not worst[0] > COSINE_BOUND:
        raise AssertionError("the updates disagree with the plain path")
    for k in degenerate:
        if not float(updates[k][0].norm()) < 1e-2 * typical:
            raise AssertionError(f"{k}: the plain path leaves it at noise")
    # and the post-update params themselves
    worst = min((_cosine(state_k.params[k], state_p.params[k]), k)
                for k in updates if k not in degenerate)
    log(f"train first step post-update params, kernels vs plain: lowest "
        f"per-leaf cosine {worst[0]:.6f} ({worst[1]}), bound {COSINE_BOUND}")
    if not worst[0] > COSINE_BOUND:
        raise AssertionError("post-update params disagree with the plain path")
    # two fp32 copies of the trained params: not to be counted in the peak
    del updates

    state_k, more, _ = run(step_kernel, state_k, TRAIN_WARMUP - 1, True)
    infos_k += more
    state_p, _, _ = run(step_plain, state_p, TRAIN_WARMUP - 1, False)
    # 8 timed steps each, in turns: plain, kernel, kernel, plain
    half = TRAIN_STEPS // 2
    times_k, times_p = [], []
    for kernel in (False, True, True, False):
        torch.cuda.reset_peak_memory_stats()
        if kernel:
            state_k, more, times = run(step_kernel, state_k, half, True)
            infos_k += more
            times_k += times
            peak_k = max(peak_k, torch.cuda.max_memory_allocated())
        else:
            state_p, _, times = run(step_plain, state_p, half, False)
            times_p += times
            peak_p = max(peak_p, torch.cuda.max_memory_allocated())
    launches = {k: counts()[k] for k in counted}
    log(f"train launches over {len(infos_k)} kernel steps: {launches}")

    # the frozen DINOv2 encode of the initial images alone, in turns
    images = batch["initial_state"]["image_primary"].squeeze(1)

    def encode_ms(apply, params, n=5):
        times = []
        with torch.no_grad():
            for _ in range(n):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                apply(params, images)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
        return times

    enc_p = encode_ms(plain_dino_apply, plain_dino_params)
    enc_k = encode_ms(dino_apply, dino_params)
    enc_k += encode_ms(dino_apply, dino_params)
    enc_p += encode_ms(plain_dino_apply, plain_dino_params)
    log(f"train frozen DINOv2 encode of {TRAIN_BATCH} images ms (median of "
        f"CUDA events): kernels {statistics.median(enc_k):.4f} plain "
        f"{statistics.median(enc_p):.4f}")

    losses = [float(info["training_loss"]) for info in infos_k]
    log(f"train losses (kernels): {[round(x, 4) for x in losses]}")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError("train loss not finite or not falling")
    k_med, p_med = statistics.median(times_k), statistics.median(times_p)
    log(f"train ms/step (median of CUDA events, {TRAIN_STEPS} steps each): "
        f"kernels {k_med:.4f} plain {p_med:.4f}; samples/s kernels "
        f"{TRAIN_BATCH * 1e3 / k_med:.1f} plain "
        f"{TRAIN_BATCH * 1e3 / p_med:.1f}; peak memory (max_memory_allocated)"
        f" kernels {peak_k / 2 ** 30:.3f} GiB plain {peak_p / 2 ** 30:.3f} "
        "GiB")
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

    # one nvcc per source, all started together, so the build time stays
    # that of the slowest source as sources are added
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        list(pool.map(cuda_build.build, SOURCES))
    log(f"build: {', '.join(SOURCES)} in {time.perf_counter() - t0:.2f} s "
        "(one nvcc each, in parallel)")

    results = kernel_phase(device)
    launches = slice_phase(device)
    train_results = train_kernel_phase(device)
    train_launches = train_phase(device)

    kernels = [
        {"name": name, "route": "cuda", "source": TRUNK_SOURCE,
         "replaces": TPU_KERNEL, "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"]}
        for name, r in results.items()
    ] + [
        {"name": name, "route": "cuda", "source": TRAIN_KERNELS[name][0],
         "replaces": TRAIN_KERNELS[name][1],
         "launches": train_launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"]}
        for name, r in train_results.items()
    ]
    log("kernels ms/plain_ms: per flagship layer for the three kernels "
        "(2 LayerNorms, 4 GEMMs, 1 attention), per 12-layer trunk for "
        "dino_layers_serving, per launch at B=64 for the training kernels; "
        "launches: over the serving steps for the first four, over the "
        "train steps for the training kernels, where mha_fused_train_fwd "
        "counts the trunk's attention forward and dino_layer_train_fwd "
        "counts layer calls, each of which also launches the attention "
        "forward kernel once (P store off)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
