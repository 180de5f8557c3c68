"""BaseNetwork: the generated policy (counterpart of
hypervla_tpu/models/base_network.py), for model_type "vit" with the mix
action head. Its params are a flat dict keyed by the JAX package's paths;
at serving time they come from the hypernetwork once per episode, in
training per sample (a leading batch axis, models/hypernetwork.py::
per_sample_view).
"""
from typing import Dict, Tuple

import torch

from hypervla_tpu_torch.models import layers
from hypervla_tpu_torch.models.action_heads import MixActionHead
from hypervla_tpu_torch.models.base_vit import ViT


class BaseNetwork:
    def __init__(self, model_type: str, action_head_type: str,
                 vit_kwargs: dict, action_head_kwargs: dict,
                 action_horizon: int = 4, action_dim: int = 7):
        if model_type != "vit" or action_head_type != "mix":
            raise NotImplementedError(
                f"model_type={model_type!r}, action_head_type="
                f"{action_head_type!r}: only the vit + mix policy is ported "
                "(ROADMAP.md, queue A3)"
            )
        self.action_head = MixActionHead(action_horizon, action_dim,
                                         action_head_kwargs)
        # the mix head reads one readout token
        self.encoder = ViT(vit_kwargs, action_token_num=1)

    def encode(self, params, images, trunk_impl: str = "kernel"):
        """(B, H, W, C) uint8 -> readout tokens (B, window=1, n, emb)."""
        return self.encoder(params, images, trunk_impl)[:, None]

    def loss(self, params: Dict[str, torch.Tensor], batch: dict,
             image_embeddings):
        """Per-sample loss (B,) and metrics of the policy on a training
        batch, from the batched trunk's patch embeddings (B, patches, dim):
        the mix head's loss on the batch's actions and masks."""
        tokens = self.encoder(params, image_embeddings=image_embeddings)
        return self.action_head.loss(
            params, tokens[:, None], batch["action"],
            batch["observation"]["timestep_pad_mask"],
            batch["action_pad_mask"])

    def predict_action(self, params: Dict[str, torch.Tensor], images,
                       trunk_impl: str = "kernel"):
        """images (B, H, W, C) or (B, 1, H, W, C) uint8 -> action chunk
        (B, horizon, action_dim)."""
        if images.dim() == 5 and images.shape[1] == 1:
            images = images.squeeze(1)
        return self.action_head.predict_action(
            params, self.encode(params, images, trunk_impl))

    def specs(self) -> Dict[str, Tuple[tuple, layers.Init]]:
        specs = self.encoder.specs()
        specs.update(self.action_head.specs(self.encoder.hidden_dim))
        return specs
