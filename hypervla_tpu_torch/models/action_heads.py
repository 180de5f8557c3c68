"""The mix action head (counterpart of
hypervla_tpu/models/action_heads.py::MixActionHead): tanh-squashed
continuous arm dims plus a binary gripper decoded from the sign of its
logit, and its training loss. The other heads (continuous, discrete,
diffusion) are not ported yet (ROADMAP.md, queue A3).
"""
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from hypervla_tpu_torch.models import layers


def masked_mean(x, mask):
    """Per-sample mean of x where the (broadcast) mask is set, as the JAX
    package's masked_mean takes it inside its per-sample vmap:
    mean(x * mask) / max(mean(mask), 1e-5) over all but the leading axis."""
    mask = mask.expand_as(x).to(x.dtype)
    denom = torch.clamp(mask.flatten(1).mean(1), min=1e-5)
    return (x * mask).flatten(1).mean(1) / denom


class MixActionHead:
    def __init__(self, action_horizon: int, action_dim: int,
                 action_head_kwargs: dict):
        kw = action_head_kwargs
        if tuple(kw.get("hidden_dims", ())) or kw["token_per_horizon"]:
            raise NotImplementedError(
                "MixActionHead hidden_dims and token_per_horizon are not "
                "ported yet (ROADMAP.md)")
        self.action_horizon = action_horizon
        self.action_dim = action_dim
        self.squash = kw["squash_continuous_action"]
        self.tanh_scaling_factor = kw.get("tanh_scaling_factor", 5.0)
        self.max_action = kw.get("max_action", 5.0)
        self.clip_target = kw.get("clip_target", False)

    def __call__(self, params: Dict[str, torch.Tensor], tokens):
        """tokens (B, window, 1, emb) -> (arm (B, window, horizon,
        action_dim - 1), gripper_logits (B, window, horizon, 1)): one
        readout token emits the whole chunk."""
        emb = tokens.squeeze(2)
        arm = layers.dense(emb, params["action_head/continuous_head/kernel"],
                           params["action_head/continuous_head/bias"])
        grip = layers.dense(emb, params["action_head/discrete_head/kernel"],
                            params["action_head/discrete_head/bias"])
        arm = arm.reshape(*arm.shape[:2], self.action_horizon,
                          self.action_dim - 1)
        grip = grip[..., None]
        if self.squash:
            arm = torch.tanh(arm / self.tanh_scaling_factor) * self.max_action
        return arm, grip

    def loss(self, params: Dict[str, torch.Tensor], tokens, actions,
             timestep_pad_mask, action_pad_mask):
        """Per-sample loss (B,) and metrics: the masked arm MSE times
        (action_dim - 1) plus the masked sigmoid cross-entropy of the
        gripper. actions, action_pad_mask (B, window, horizon, action_dim);
        timestep_pad_mask (B, window)."""
        arm, grip = self(params, tokens)
        if self.clip_target:
            actions = torch.clamp(actions, -self.max_action, self.max_action)
        mask = timestep_pad_mask[:, :, None, None] & action_pad_mask
        arm_loss = masked_mean(torch.square(arm - actions[..., :-1]),
                               mask[..., :-1]) * (self.action_dim - 1)
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
        arm_out = (self.action_dim - 1) * self.action_horizon
        grip_out = self.action_horizon
        return {
            "action_head/continuous_head/bias": ((arm_out,), layers.zeros),
            "action_head/continuous_head/kernel": (
                (emb_dim, arm_out), layers.lecun_normal),
            "action_head/discrete_head/bias": ((grip_out,), layers.zeros),
            "action_head/discrete_head/kernel": (
                (emb_dim, grip_out), layers.lecun_normal),
        }
