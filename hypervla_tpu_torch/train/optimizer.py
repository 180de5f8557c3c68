"""The optimizer (counterpart of hypervla_tpu/train/optimizer.py): LR
schedules, the weight-decay masks, the generated/shared labels and AdamW
with global-norm clipping, split into a `generated` and a `shared` group
that each have their own LR schedule and weight decay, the first moment
stored in bf16; per leaf, or packed into one flat buffer per group and
decay flag (`packed`); with gradient accumulation
(`grad_accumulation_steps`, optax.MultiSteps) and frozen params
(`frozen_keys`) around it (`Optimizer`).

Written out in plain PyTorch to reproduce optax's arithmetic step for step
(`clip_by_global_norm`, then per group `scale_by_adam(mu_dtype=bf16)`,
`add_decayed_weights` under the mask and `scale_by_learning_rate`), as
the compiled (jitted) JAX step rounds it: the first moment is updated from
its stored bf16 value, with b1 rounded to bf16 (a Python scalar takes the
array's dtype in JAX) and its product with the stored moment taken in fp32
and not rounded (optax's ops run eagerly would round it to bf16), and
`(1 - b1) * g` added to it as XLA compiles the sum, one fused
multiply-add, so that the new moment is rounded to fp32 once, then
bias-corrected in fp32 and cast to bf16 once, for the state; weight
decay is `wd * p` on the pre-update param; the schedules run in fp32 on
the optimizer's own update count, as optax's do. Params, grads and
updates are flat dicts keyed like the port's params (the JAX key path
joined with "/").
"""
import logging
import math
from fnmatch import fnmatch
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


def clip_by_global_norm(grads: Params, max_norm: float,
                        norm: Callable = global_norm) -> Params:
    """optax.clip_by_global_norm: the grads as they are where their global
    norm is below max_norm, else each scaled to (g / norm) * max_norm.
    norm: the global norm of the tree (on a mesh, of every rank's shards,
    the same on every rank, so that every rank takes the same branch)."""
    g_norm = norm(grads)
    if bool(g_norm < max_norm):
        return grads
    return {k: (g / g_norm) * max_norm for k, g in grads.items()}


def _adamw(g, mu, nu, p, c1, c2, step_size, wd, b1, b1_bf16, b2, eps):
    """One AdamW update of one tensor: (update, new bf16 mu, new nu). The
    per-leaf and the packed optimizer both run this, so their updates are
    equal bit for bit. The first moment is the compiled JAX step's
    fma((1 - b1), g, b1_bf16 * mu), with b1_bf16 the bf16 value of b1 as a
    float: the product of the bf16 b1 and the stored bf16 moment is exact
    in fp64 (8 + 8 significant bits), and so is (1 - b1) * g (24 + 24), so
    their sum in fp64, rounded to fp32, is the fused multiply-add's single
    rounding (a separate fp32 product and sum differ from it on about one
    element in 2^15). Three elementwise passes: the moment to fp64, its
    scaling by b1, and the sum with the fp32 g scaled in fp64 by the
    add's alpha, stored as fp32."""
    mu = torch.add(mu.double().mul_(b1_bf16), g, alpha=float(_F(1 - b1)),
                   out=torch.empty_like(g, dtype=torch.float32))
    nu = (1 - b2) * g * g + b2 * nu
    u = (mu / c1) / (torch.sqrt(nu / c2) + eps)
    if wd:
        u = u + wd * p
    return step_size * u, mu.bfloat16(), nu


class AdamW:
    """AdamW per label group, one op chain per leaf. State: the update
    count (which also drives the LR schedules, as optax's own count does),
    the bf16 first moment and the fp32 second moment of every leaf it is
    given."""

    def __init__(self, labels: Dict[str, str], decay_mask: Dict[str, bool],
                 schedules: Dict[str, Schedule],
                 weight_decays: Dict[str, float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.labels = labels
        self.decay_mask = decay_mask
        self.schedules = schedules
        self.weight_decays = weight_decays
        self.b1, self.b2, self.eps = b1, b2, eps
        self.b1_bf16 = float(torch.tensor(b1, dtype=torch.bfloat16))

    def _scalars(self, count: int):
        """(c1, c2, {group: -lr}) of the update after `count` updates."""
        count_inc = count + 1
        c1 = float(_F(1) - _F(self.b1) ** _F(count_inc))
        c2 = float(_F(1) - _F(self.b2) ** _F(count_inc))
        step_size = {group: float(-_F(fn(count)))
                     for group, fn in self.schedules.items()}
        return c1, c2, step_size

    def _decay(self, label: str, decayed: bool) -> float:
        return self.weight_decays[label] if decayed else 0.0

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
        c1, c2, step_size = self._scalars(state["count"])
        updates, mu_new, nu_new = {}, {}, {}
        for name, g in grads.items():
            label = self.labels[name]
            updates[name], mu_new[name], nu_new[name] = _adamw(
                g, state["mu"][name], state["nu"][name], params[name], c1,
                c2, step_size[label],
                self._decay(label, self.decay_mask[name]), self.b1,
                self.b1_bf16, self.b2, self.eps)
        return updates, {"count": state["count"] + 1, "mu": mu_new,
                         "nu": nu_new}


class PackedAdamW(AdamW):
    """AdamW over one flat buffer per (label, decayed) group
    (hypervla_tpu/train/optimizer.py::_packed_adamw, optimizer.packed=True):
    within a group the LR schedule and the weight decay are one, so the
    elementwise AdamW over the concatenated leaves is the per-leaf one, bf16
    first moment included, in one op chain per group instead of one per
    leaf. State: {str((label, decayed)): {"count", "mu", "nu"}}, the
    moments flat, as the JAX package's {group: adamw state}."""

    def __init__(self, names, labels, decay_mask, schedules, weight_decays,
                 **adam_kwargs):
        super().__init__(labels, decay_mask, schedules, weight_decays,
                         **adam_kwargs)
        members: Dict[tuple, list] = {}
        for name in names:
            members.setdefault((labels[name], bool(decay_mask[name])),
                               []).append(name)
        self.members = {str(g): (g, members[g]) for g in sorted(members)}

    def init(self, params: Params) -> dict:
        state = {}
        for key, (_, names) in self.members.items():
            size = sum(params[n].numel() for n in names)
            device = params[names[0]].device
            state[key] = {
                "count": 0,
                "mu": torch.zeros(size, dtype=torch.bfloat16, device=device),
                "nu": torch.zeros(size, dtype=torch.float32, device=device),
            }
        return state

    @torch.no_grad()
    def update(self, grads: Params, state: dict, params: Params):
        out, new_state = {}, {}
        for key, ((label, decayed), names) in self.members.items():
            s = state[key]
            c1, c2, step_size = self._scalars(s["count"])
            wd = self._decay(label, decayed)
            flat_p = (torch.cat([params[n].reshape(-1) for n in names])
                      if wd else None)
            u, mu, nu = _adamw(
                torch.cat([grads[n].reshape(-1) for n in names]), s["mu"],
                s["nu"], flat_p, c1, c2, step_size[label], wd, self.b1,
                self.b1_bf16, self.b2, self.eps)
            new_state[key] = {"count": s["count"] + 1, "mu": mu, "nu": nu}
            sizes = [grads[n].numel() for n in names]
            for n, part in zip(names, torch.split(u, sizes)):
                out[n] = part.view(grads[n].shape)
        return {n: out[n] for n in grads}, new_state


class Optimizer:
    """The chain around an inner AdamW, as the JAX package composes it:
    `frozen_keys` partition the params (optax.multi_transform: the frozen
    get zero updates and no state), the trainable go through global-norm
    clipping, then gradient accumulation (optax.MultiSteps: the running
    mean of the clipped micro-gradients, the inner AdamW applied to it
    every k-th call and zero updates on the others; the inner update count,
    which drives the LR schedules, advances only when it applies), then the
    inner AdamW. State: the inner state where k is 1, else {"mini_step",
    "gradient_step", "acc_grads", "inner"}."""

    def __init__(self, inner: AdamW, clip_gradient: Optional[float] = None,
                 accumulation_steps: int = 1, frozen=frozenset()):
        if accumulation_steps < 1:
            raise ValueError("grad_accumulation_steps must be at least 1")
        self.inner = inner
        self.clip_gradient = clip_gradient
        self.k = int(accumulation_steps)
        self.frozen = frozenset(frozen)

    def trainable(self, tree: Params) -> Params:
        return {k: v for k, v in tree.items() if k not in self.frozen}

    def init(self, params: Params) -> dict:
        params = self.trainable(params)
        inner = self.inner.init(params)
        if self.k == 1:
            return inner
        return {"mini_step": 0, "gradient_step": 0,
                "acc_grads": {k: torch.zeros_like(v)
                              for k, v in params.items()},
                "inner": inner}

    @torch.no_grad()
    def update(self, grads: Params, state: dict, params: Params,
               norm: Callable = global_norm):
        """Returns (updates, new_state): an update for every leaf of grads,
        zeros for the frozen ones. norm: the clip's global norm."""
        g = self.trainable(grads)
        if self.clip_gradient is not None:
            g = clip_by_global_norm(g, self.clip_gradient, norm)
        p = self.trainable(params)
        if self.k == 1:
            updates, state = self.inner.update(g, state, p)
        else:
            mini = state["mini_step"]
            acc = {k: a + (g[k] - a) / float(mini + 1)
                   for k, a in state["acc_grads"].items()}
            if mini == self.k - 1:
                updates, inner = self.inner.update(acc, state["inner"], p)
                state = {"mini_step": 0,
                         "gradient_step": state["gradient_step"] + 1,
                         "acc_grads": {k: torch.zeros_like(a)
                                       for k, a in acc.items()},
                         "inner": inner}
            else:
                updates = {k: torch.zeros_like(v) for k, v in g.items()}
                state = {"mini_step": mini + 1,
                         "gradient_step": state["gradient_step"],
                         "acc_grads": acc, "inner": state["inner"]}
        return {k: updates[k] if k in updates else torch.zeros_like(v)
                for k, v in grads.items()}, state


def frozen_names(params: Params, frozen_keys) -> set:
    """The params whose path, joined with ".", fnmatches any of frozen_keys
    (hypervla_tpu/train/optimizer.py::freeze_weights; the port joins paths
    with "/")."""
    return {name for name in params
            if any(fnmatch(name.replace("/", "."), key)
                   for key in frozen_keys or ())}


def create_optimizer(params: Params, hn_param_type: Dict[str, str],
                     weight_decay_strategy: str = "v1", **kwargs):
    """Returns (tx, lr_callable, base_lr_callable, param_norm_callable), as
    the JAX package's create_optimizer does. hn_param_type labels every
    param "generated" or "shared" (`hn_param_type_tree`). With frozen_keys
    the param norm leaves the frozen params out, as there."""
    frozen_keys = kwargs.get("frozen_keys")
    packed = kwargs.get("packed", False)
    if packed and frozen_keys:
        raise ValueError(
            "optimizer.packed=True cannot be combined with frozen_keys: "
            "the freeze wrapper changes the leaf structure the packing "
            "spec is built from. Use per-leaf mode for frozen runs.")
    if frozen_keys:
        logging.info(f"Freezing parameters matching: {frozen_keys}.")

    def schedule(value):
        if isinstance(value, dict):
            return create_lr_schedule(**value)
        return lambda _: float(value)

    lr_callable = schedule(kwargs["learning_rate"])
    base_lr_callable = (schedule(kwargs["base_learning_rate"])
                        if kwargs.get("base_learning_rate") is not None
                        else lr_callable)
    adam = dict(
        labels=hn_param_type,
        decay_mask=wd_mask(weight_decay_strategy, params),
        schedules={"generated": lr_callable, "shared": base_lr_callable},
        weight_decays={
            "generated": kwargs.get("weight_decay") or 0.0,
            "shared": kwargs.get("base_weight_decay") or 0.0,
        })
    inner = PackedAdamW(list(params), **adam) if packed else AdamW(**adam)
    frozen = frozen_names(params, frozen_keys)
    tx = Optimizer(inner, clip_gradient=kwargs.get("clip_gradient"),
                   accumulation_steps=kwargs.get("grad_accumulation_steps",
                                                 1),
                   frozen=frozen)
    if frozen:
        def param_norm_callable(tree, norm=global_norm):
            return norm(tx.trainable(tree))
    else:
        def param_norm_callable(tree, norm=global_norm):
            return norm(tree)
    return tx, lr_callable, base_lr_callable, param_norm_callable
