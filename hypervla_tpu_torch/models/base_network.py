"""BaseNetwork: the generated policy (counterpart of
hypervla_tpu/models/base_network.py), for model_type "vit" with the mix or
the continuous action head. Its params are a flat dict keyed by the JAX
package's paths; at serving time they come from the hypernetwork once per
episode, in training per sample (a leading batch axis,
models/hypernetwork.py::per_sample_view).

The window is one frame: the JAX ViT base net squeezes only a window of 1
(HyperVLA.sample_actions) and raises ValueError on a longer one, and so
does this one.
"""
from typing import Dict, Optional, Tuple

import torch

from hypervla_tpu_torch.models import layers
from hypervla_tpu_torch.models.action_heads import (
    ContinuousActionHead,
    MixActionHead,
)
from hypervla_tpu_torch.models.base_vit import ViT

#: the action heads the port carries
ACTION_HEADS = {"mix": MixActionHead, "continuous": ContinuousActionHead}


def readout_token_count(action_head_kwargs: dict, action_horizon: int) -> int:
    """How many readout ("action") tokens the encoder appends for a
    regression head: one per horizon step, or one in all
    (hypervla_tpu/models/base_network.py::_readout_token_count)."""
    return action_horizon if action_head_kwargs.get(
        "token_per_horizon", False) else 1


def _one_frame(images):
    """(B, 1, H, W, C) or (B, H, W, C) -> (B, H, W, C); a window of more
    frames raises ValueError, as the JAX ViT base net's squeeze does."""
    if images.dim() == 5:
        if images.shape[1] != 1:
            raise ValueError(f"a window of {images.shape[1]} frames: the ViT "
                             "base net reads one frame")
        images = images.squeeze(1)
    return images


class BaseNetwork:
    def __init__(self, model_type: str, action_head_type: str,
                 vit_kwargs: dict, action_head_kwargs: dict,
                 action_horizon: int = 4, action_dim: int = 7,
                 cnn_kwargs: Optional[dict] = None,
                 octo_kwargs: Optional[dict] = None,
                 input_shapes: Optional[dict] = None):
        """cnn_kwargs and octo_kwargs, which a JAX config carries, are
        read only by the model types that are not ported. input_shapes
        are the ViT's (models/base_vit.py::ViT)."""
        if model_type != "vit" or action_head_type not in ACTION_HEADS:
            raise NotImplementedError(
                f"model_type={model_type!r}, action_head_type="
                f"{action_head_type!r}: only the vit policy with the mix or "
                "continuous head is ported (ROADMAP.md A12.1, the other "
                "action heads; A12.2, other encoders and topologies)"
            )
        self.action_head = ACTION_HEADS[action_head_type](
            action_horizon, action_dim, action_head_kwargs)
        self.encoder = ViT(vit_kwargs, readout_token_count(
            action_head_kwargs, action_horizon), input_shapes)

    def encode(self, params, images, trunk_impl: str = "kernel",
               image_embeddings=None, instruction_embeddings=None,
               draws=None, maps=None):
        """(B, H, W, C) uint8 -> readout tokens (B, window=1, n, emb);
        draws and maps as models/base_vit.py::ViT.__call__ takes them."""
        return self.encoder(params, images, trunk_impl, image_embeddings,
                            instruction_embeddings, draws, maps)[:, None]

    def loss(self, params: Dict[str, torch.Tensor], batch: dict,
             image_embeddings=None, instruction_embeddings=None,
             draws=None, maps=None):
        """Per-sample loss (B,) and metrics of the policy on a training
        batch: the head's loss on the batch's actions and masks. The
        encoder reads the batch's frames, or on the DINOv2 path the batched
        trunk's patch embeddings (B, patches, dim); instruction_embeddings
        (B, L, token_dim) feed its language tokens. draws: the training
        forward's dropout; maps (a dict) receives the policy
        transformer's attention maps (ViT.__call__)."""
        images = None
        if image_embeddings is None:
            images = _one_frame(batch["observation"]["image_primary"])
        tokens = self.encode(params, images, image_embeddings=image_embeddings,
                             instruction_embeddings=instruction_embeddings,
                             draws=draws, maps=maps)
        return self.action_head.loss(
            params, tokens, batch["action"],
            batch["observation"]["timestep_pad_mask"],
            batch["action_pad_mask"])

    def predict_action(self, params: Dict[str, torch.Tensor], images,
                       trunk_impl: str = "kernel",
                       instruction_embeddings=None, maps=None):
        """images (B, H, W, C) or (B, 1, H, W, C) uint8 -> action chunk
        (B, horizon, action_dim); maps (a dict) receives the attention
        maps (ViT.__call__)."""
        images = _one_frame(images)
        return self.action_head.predict_action(
            params, self.encode(params, images, trunk_impl,
                                instruction_embeddings=instruction_embeddings,
                                maps=maps))

    def specs(self) -> Dict[str, Tuple[tuple, layers.Init]]:
        specs = self.encoder.specs()
        specs.update(self.action_head.specs(self.encoder.hidden_dim))
        return specs
