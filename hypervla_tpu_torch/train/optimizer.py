"""The optimizer (counterpart of hypervla_tpu/train/optimizer.py): LR
schedules, the weight-decay masks, the generated/shared labels and AdamW
with global-norm clipping, split into a `generated` and a `shared` group
that each have their own LR schedule and weight decay, the first moment
stored in bf16.

Written out in plain PyTorch to reproduce optax's arithmetic step for step
(`clip_by_global_norm`, then per group `scale_by_adam(mu_dtype=bf16)`,
`add_decayed_weights` under the mask and `scale_by_learning_rate`): the
first moment is updated from its stored bf16 value, whose decay term is a
bf16 product with b1 rounded to bf16 (a Python scalar takes the array's
dtype in JAX), bias-corrected in fp32 and only then cast to bf16; weight
decay is `wd * p` on the pre-update param; the schedules run in fp32 on
the optimizer's own update count, as optax's do. Params, grads and
updates are flat dicts keyed like the port's params (the JAX key path
joined with "/").
"""
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

Params = Dict[str, torch.Tensor]
Schedule = Callable[[int], float]

_F = np.float32


def _linear(init_value, end_value, transition_steps) -> Schedule:
    """optax.linear_schedule, in fp32."""
    if transition_steps <= 0:
        return lambda count: float(init_value)

    def schedule(count):
        count = _F(min(max(count, 0), transition_steps))
        frac = _F(1) - count / _F(transition_steps)
        return float(_F(init_value - end_value) * frac + _F(end_value))

    return schedule


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    """optax.join_schedules: the second schedule sees `step - boundary`."""
    return lambda step: first(step) if step < boundary else second(
        step - boundary)


def create_lr_schedule(name: str, **kwargs) -> Schedule:
    """step -> learning rate: "rsqrt", "cosine" or "constant", each after a
    linear warmup from init_value to peak_value."""
    warmup = kwargs["warmup_steps"]
    peak = kwargs["peak_value"]
    if name == "cosine":
        decay_steps = kwargs["decay_steps"] - warmup
        if decay_steps <= 0:
            raise ValueError("cosine schedule needs decay_steps > "
                             "warmup_steps")
        end = kwargs.get("end_value", 0.0)
        alpha = 0.0 if peak == 0.0 else end / peak
        exponent = kwargs.get("exponent", 1.0)

        def cosine(count):
            count = _F(min(count, decay_steps))
            decay = _F(0.5) * (_F(1) + np.cos(_F(math.pi) * count
                                              / _F(decay_steps)))
            return float(_F(peak) * (_F(1 - alpha) * decay ** _F(exponent)
                                     + _F(alpha)))

        return _join(_linear(kwargs["init_value"], peak, warmup), cosine,
                     warmup)
    if name == "rsqrt":
        timescale = kwargs.get("timescale", 10000)

        def rsqrt(step):
            return float(_F(peak) / np.sqrt(
                _F(step + timescale) / _F(timescale)))

        return _join(_linear(kwargs["init_value"], peak, warmup), rsqrt,
                     warmup)
    if name == "constant":
        return _join(_linear(kwargs["init_value"], peak, warmup),
                     lambda step: float(peak), warmup)
    raise ValueError(f"Unsupported lr schedule: {name}")


def _first(path: str) -> str:
    return path.split("/", 1)[0]


def wd_mask(weight_decay_strategy: str, params: Params) -> Dict[str, bool]:
    """Which params take weight decay (hypervla_tpu/train/optimizer.py::
    _wd_mask); "v4" and unknown names use v1's mask, as there."""
    def v2(path):
        return not ("norm" in path.lower() and "output_head" not in path)

    def v3(path):
        if "output_head" in _first(path):
            return "kernel" in _first(path)
        return "image_encoder" in path or "kernel" in path

    def v5(path):
        # an output head that generates a kernel is decayed in both its
        # kernel and its bias leaf: the test reads the first component
        if "output_head" in _first(path):
            return "kernel" in _first(path)
        return "image_encoder" in path

    rule = {"v2": v2, "v3": v3, "v5": v5}.get(
        weight_decay_strategy, lambda path: "kernel" in path)
    return {name: rule(name) for name in params}


def hn_param_type_tree(params: Params) -> Dict[str, str]:
    """"shared" for params whose first path component names the image
    encoder, "generated" for the rest."""
    return {name: "shared" if "image_encoder" in _first(name)
            else "generated" for name in params}


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tree.values()))


class AdamW:
    """Global-norm clipping, then AdamW per label group. State: the update
    count (which also drives the LR schedules, as optax's own count does),
    the bf16 first moment and the fp32 second moment."""

    def __init__(self, labels: Dict[str, str], decay_mask: Dict[str, bool],
                 schedules: Dict[str, Schedule],
                 weight_decays: Dict[str, float],
                 clip_gradient: Optional[float] = None, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.labels = labels
        self.decay_mask = decay_mask
        self.schedules = schedules
        self.weight_decays = weight_decays
        self.clip_gradient = clip_gradient
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Params) -> dict:
        return {
            "count": 0,
            "mu": {k: torch.zeros_like(v, dtype=torch.bfloat16)
                   for k, v in params.items()},
            "nu": {k: torch.zeros_like(v, dtype=torch.float32)
                   for k, v in params.items()},
        }

    @torch.no_grad()
    def update(self, grads: Params, state: dict, params: Params):
        """Returns (updates, new_state); the updates are added to params."""
        if self.clip_gradient is not None:
            g_norm = global_norm(grads)
            if not bool(g_norm < self.clip_gradient):
                grads = {k: (g / g_norm) * self.clip_gradient
                         for k, g in grads.items()}
        count = state["count"]
        count_inc = count + 1
        c1 = float(_F(1) - _F(self.b1) ** _F(count_inc))
        c2 = float(_F(1) - _F(self.b2) ** _F(count_inc))
        step_size = {group: -_F(fn(count))
                     for group, fn in self.schedules.items()}
        b1_bf16 = torch.tensor(self.b1, dtype=torch.bfloat16)
        updates, mu_new, nu_new = {}, {}, {}
        for name, g in grads.items():
            group = self.labels[name]
            mu = (1 - self.b1) * g + b1_bf16 * state["mu"][name]
            nu = (1 - self.b2) * g * g + self.b2 * state["nu"][name]
            u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            wd = self.weight_decays[group]
            if self.decay_mask[name] and wd:
                u = u + wd * params[name]
            updates[name] = float(step_size[group]) * u
            mu_new[name] = mu.bfloat16()
            nu_new[name] = nu
        return updates, {"count": count_inc, "mu": mu_new, "nu": nu_new}


def create_optimizer(params: Params, hn_param_type: Dict[str, str],
                     weight_decay_strategy: str = "v1", **kwargs):
    """Returns (tx, lr_callable, base_lr_callable, param_norm_callable), as
    the JAX package's create_optimizer does. hn_param_type labels every
    param "generated" or "shared" (`hn_param_type_tree`)."""
    unported = {
        "grad_accumulation_steps > 1 (optax.MultiSteps)":
            kwargs.get("grad_accumulation_steps", 1) > 1,
        "packed": kwargs.get("packed", False),
        "frozen_keys": bool(kwargs.get("frozen_keys")),
    }
    for name, bad in unported.items():
        if bad:
            raise NotImplementedError(
                f"optimizer {name} is not ported yet (ROADMAP.md A2.1)")

    def schedule(value):
        if isinstance(value, dict):
            return create_lr_schedule(**value)
        return lambda _: float(value)

    lr_callable = schedule(kwargs["learning_rate"])
    base_lr_callable = (schedule(kwargs["base_learning_rate"])
                        if kwargs.get("base_learning_rate") is not None
                        else lr_callable)
    tx = AdamW(
        labels=hn_param_type,
        decay_mask=wd_mask(weight_decay_strategy, params),
        schedules={"generated": lr_callable, "shared": base_lr_callable},
        weight_decays={
            "generated": kwargs.get("weight_decay") or 0.0,
            "shared": kwargs.get("base_weight_decay") or 0.0,
        },
        clip_gradient=kwargs.get("clip_gradient"),
    )
    return tx, lr_callable, base_lr_callable, global_norm
