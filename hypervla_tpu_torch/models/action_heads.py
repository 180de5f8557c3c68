"""The mix action head (counterpart of
hypervla_tpu/models/action_heads.py::MixActionHead): tanh-squashed
continuous arm dims plus a binary gripper decoded from the sign of its
logit. The other heads (continuous, discrete, diffusion) are not ported yet
(ROADMAP.md, queue A3).
"""
from typing import Dict, Tuple

import torch

from hypervla_tpu_torch.models import layers


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
