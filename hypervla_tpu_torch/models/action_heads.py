"""The regression action heads (counterpart of
hypervla_tpu/models/action_heads.py): `MixActionHead`, tanh-squashed
continuous arm dims plus a binary gripper decoded from the sign of its
logit, and `ContinuousActionHead`, tanh-squashed regression of every
action dim, with their training losses. Each predicts a chunk of
`action_horizon` actions at each window step and decodes the last one.
MAP pooling (use_map) and the discrete and diffusion heads are not ported
yet (ROADMAP.md A12.1, the other action heads).
"""
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from hypervla_tpu_torch.models import layers


#: the per-element penalties of continuous_loss
PENALTIES = {"mse": torch.square, "l1": torch.abs}


def masked_mean(x, mask):
    """Per-sample mean of x where the (broadcast) mask is set, as the JAX
    package's masked_mean takes it inside its per-sample vmap:
    mean(x * mask) / max(mean(mask), 1e-5) over all but the leading axis."""
    mask = mask.expand_as(x).to(x.dtype)
    denom = torch.clamp(mask.flatten(1).mean(1), min=1e-5)
    return (x * mask).flatten(1).mean(1) / denom


def continuous_loss(pred, target, mask, loss_type: str = "mse"):
    """Per-sample masked penalty of pred - target and its metrics
    {"loss", "mse"} (hypervla_tpu/models/action_heads.py::
    continuous_loss)."""
    if loss_type not in PENALTIES:
        raise ValueError(f"Invalid loss type: {loss_type}")
    err = pred - target
    loss = masked_mean(PENALTIES[loss_type](err), mask)
    mse = (loss if loss_type == "mse"
           else masked_mean(torch.square(err), mask))
    return loss, {"loss": loss, "mse": mse}


def chunk_mask(timestep_pad_mask, action_pad_mask):
    """(B, window) & (B, window, horizon, action_dim) -> the per-element
    loss mask."""
    return timestep_pad_mask[:, :, None, None] & action_pad_mask


def _head(params, name, x):
    return layers.dense(x, params[f"action_head/{name}/kernel"],
                        params[f"action_head/{name}/bias"])


def _dense_specs(name, fan_in, fan_out):
    return {f"action_head/{name}/bias": ((fan_out,), layers.zeros),
            f"action_head/{name}/kernel": ((fan_in, fan_out),
                                           layers.lecun_normal)}


class ChunkedHead:
    """The settings the regression heads share: the chunk geometry, the
    loss type and the tanh squashing and target clipping."""

    def __init__(self, action_horizon: int, action_dim: int,
                 action_head_kwargs: dict):
        kw = action_head_kwargs
        if kw.get("use_map", False):
            raise NotImplementedError(
                "action_head_kwargs use_map=True: MAP pooling is not ported "
                "yet (ROADMAP.md A12.1, the other action heads)")
        self.action_horizon = action_horizon
        self.action_dim = action_dim
        self.token_per_horizon = kw.get("token_per_horizon", False)
        self.loss_type = kw.get("loss_type", "mse")
        self.squash = kw.get("squash_continuous_action", True)
        self.tanh_scaling_factor = kw.get("tanh_scaling_factor", 5.0)
        self.max_action = kw.get("max_action", 5.0)
        self.clip_target = kw.get("clip_target", False)

    def _maybe_squash(self, x):
        if not self.squash:
            return x
        return torch.tanh(x / self.tanh_scaling_factor) * self.max_action

    def _maybe_clip_target(self, actions):
        if not self.clip_target:
            return actions
        return torch.clamp(actions, -self.max_action, self.max_action)


class ContinuousActionHead(ChunkedHead):
    """Tanh-squashed continuous regression of every action dim, from the
    mean of the readout tokens. It reads only its own keys of
    action_head_kwargs (the JAX head takes every key as a field and raises
    on the other heads' keys that the JAX configs carry); hidden layers are
    the mix head's, and a config that asks the continuous head for them
    raises."""

    def __init__(self, action_horizon: int, action_dim: int,
                 action_head_kwargs: dict):
        super().__init__(action_horizon, action_dim, action_head_kwargs)
        if tuple(action_head_kwargs.get("hidden_dims", ())):
            raise ValueError("action_head_kwargs hidden_dims: the "
                             "continuous head has no hidden layers (they "
                             "are the mix head's)")

    def __call__(self, params: Dict[str, torch.Tensor], tokens):
        """tokens (B, window, n, emb) -> (B, window, horizon, action_dim)."""
        mean = _head(params, "mean_proj", tokens.mean(-2))
        mean = mean.reshape(*mean.shape[:2], self.action_horizon,
                            self.action_dim)
        return self._maybe_squash(mean)

    def loss(self, params: Dict[str, torch.Tensor], tokens, actions,
             timestep_pad_mask, action_pad_mask):
        """Per-sample loss (B,) and metrics {"loss", "mse"}, each a per-dim
        mean times action_dim."""
        loss, metrics = continuous_loss(
            self(params, tokens), self._maybe_clip_target(actions),
            chunk_mask(timestep_pad_mask, action_pad_mask), self.loss_type)
        return loss * self.action_dim, {k: v * self.action_dim
                                        for k, v in metrics.items()}

    def predict_action(self, params, tokens):
        """The last window step's chunk (B, horizon, action_dim)."""
        return self(params, tokens)[:, -1]

    def specs(self, emb_dim: int) -> Dict[str, Tuple[tuple, layers.Init]]:
        return _dense_specs("mean_proj", emb_dim,
                            self.action_horizon * self.action_dim)


class MixActionHead(ChunkedHead):
    """Continuous arm dims plus a binary gripper dim. With
    token_per_horizon one readout token per horizon step emits that step,
    else one token emits the whole chunk; hidden_dims put Dense ->
    LayerNorm -> swish layers before the two heads."""

    def __init__(self, action_horizon: int, action_dim: int,
                 action_head_kwargs: dict):
        super().__init__(action_horizon, action_dim, action_head_kwargs)
        self.hidden_dims = tuple(action_head_kwargs.get("hidden_dims", ()))

    def __call__(self, params: Dict[str, torch.Tensor], tokens):
        """tokens (B, window, n, emb), n = horizon with token_per_horizon
        else 1 -> (arm (B, window, horizon, action_dim - 1),
        gripper_logits (B, window, horizon, 1))."""
        expected = self.action_horizon if self.token_per_horizon else 1
        if tokens.shape[2] != expected:
            raise ValueError(f"token number {tokens.shape[2]} != {expected}")
        # (B, window * tokens, emb): a per-sample kernel (B, emb, out)
        # applies as one batched matmul
        emb = tokens.flatten(1, 2)
        for i in range(len(self.hidden_dims)):
            emb = _head(params, f"Dense_{i}", emb)
            emb = F.silu(layers.layer_norm(
                emb, params[f"action_head/LayerNorm_{i}/scale"],
                params[f"action_head/LayerNorm_{i}/bias"]))
        lead = tokens.shape[:2]
        arm = _head(params, "continuous_head", emb).reshape(
            *lead, self.action_horizon, self.action_dim - 1)
        grip = _head(params, "discrete_head", emb).reshape(
            *lead, self.action_horizon, 1)
        return self._maybe_squash(arm), grip

    def loss(self, params: Dict[str, torch.Tensor], tokens, actions,
             timestep_pad_mask, action_pad_mask):
        """Per-sample loss (B,) and metrics: the masked arm loss times
        (action_dim - 1) plus the masked sigmoid cross-entropy of the
        gripper. actions, action_pad_mask (B, window, horizon, action_dim);
        timestep_pad_mask (B, window)."""
        arm, grip = self(params, tokens)
        actions = self._maybe_clip_target(actions)
        mask = chunk_mask(timestep_pad_mask, action_pad_mask)
        arm_loss, _ = continuous_loss(arm, actions[..., :-1], mask[..., :-1],
                                      self.loss_type)
        arm_loss = arm_loss * (self.action_dim - 1)
        bce = F.binary_cross_entropy_with_logits(
            grip, actions[..., -1:], reduction="none")
        gripper_loss = masked_mean(bce, mask[..., -1:])
        return arm_loss + gripper_loss, {"continuous_loss": arm_loss,
                                         "gripper_loss": gripper_loss}

    def predict_action(self, params, tokens):
        """The last window step's chunk (B, horizon, action_dim), gripper
        decoded as (logit >= 0)."""
        arm, grip = self(params, tokens)
        action = torch.cat([arm, (grip >= 0.0).float()], dim=-1)
        return action[:, -1]

    def specs(self, emb_dim: int) -> Dict[str, Tuple[tuple, layers.Init]]:
        specs = {}
        for i, dim in enumerate(self.hidden_dims):
            specs.update(_dense_specs(f"Dense_{i}", emb_dim, dim))
            specs[f"action_head/LayerNorm_{i}/bias"] = ((dim,), layers.zeros)
            specs[f"action_head/LayerNorm_{i}/scale"] = ((dim,), layers.ones)
            emb_dim = dim
        per_token = self.token_per_horizon
        horizon = 1 if per_token else self.action_horizon
        specs.update(_dense_specs("continuous_head", emb_dim,
                                  horizon * (self.action_dim - 1)))
        specs.update(_dense_specs("discrete_head", emb_dim, horizon))
        return specs
