"""BaseNetwork: the generated policy (counterpart of
hypervla_tpu/models/base_network.py), for model_type "vit" with any of the
four action heads that the JAX BaseNetwork builds: mix, continuous,
discrete and diffusion, each built from action_head_kwargs as the JAX one
builds it. Its params are a flat dict keyed by the JAX package's paths; at
serving time they come from the hypernetwork once per episode, in training
per sample (a leading batch axis, models/hypernetwork.py::per_sample_view).

The window is one frame: the JAX ViT base net squeezes only a window of 1
(HyperVLA.sample_actions) and raises ValueError on a longer one, and so
does this one.

model_type "cnn" (the JAX default's) raises TypeError, as the JAX model
does at init: its BaseNetwork.encode calls the encoder with the
instruction embeddings, train and image_embeddings, and the JAX CNN takes
the image alone. models/base_cnn.py carries the CNN itself.

model_type "octo" builds the Octo transformer (models/base_octo.py, under
"encoder/") from octo_kwargs, the config's "model" dict, as the JAX
package does: its image tokenizers from their ModuleSpecs (none with
use_pretrained_image_tokenizer), one "action" readout group of the head's
readout tokens, use_correct_attention on. Its loss runs the transformer
on the batch's observations and its task (the instruction's token
embedding in the task), as the JAX BaseNetwork._embed_batch does. Serving
raises TypeError, as the JAX model does: its encode calls the encoder the
ViT's way, with image_embeddings, which OctoTransformer does not take.
The JAX weight plan of an Octo base net needs share_layer_index (without
it, it walks the ViT's stem and raises KeyError; models/weight_plan.py
does the same).
"""
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from hypervla_tpu_torch.models import layers
from hypervla_tpu_torch.models.action_heads import (
    ContinuousActionHead,
    DiffusionActionHead,
    DiscreteActionHead,
    MixActionHead,
)
from hypervla_tpu_torch.models.base_octo import OctoTransformer
from hypervla_tpu_torch.models.base_vit import ViT
from hypervla_tpu_torch.models.draws import as_draws
from hypervla_tpu_torch.utils.spec import ModuleSpec


def build_action_head(action_head_type: str, action_head_kwargs: dict,
                      action_horizon: int, action_dim: int):
    """The head as hypervla_tpu/models/base_network.py::_build_action_head
    builds it: the diffusion head from the named keys
    diffusion_dropout_rate, num_blocks and hidden_dim (one diffusion sample
    a step), the discrete head's layout from discrete_token_type, the mix
    head from its named keys, the continuous head from all of them."""
    kw = action_head_kwargs
    if action_head_type == "diffusion":
        return DiffusionActionHead(
            action_horizon, action_dim, n_diffusion_samples=1,
            dropout_rate=kw.get("diffusion_dropout_rate", 0.0),
            num_blocks=kw.get("num_blocks", 3),
            hidden_dim=kw.get("hidden_dim", 256))
    if action_head_type == "continuous":
        return ContinuousActionHead(action_horizon, action_dim, kw)
    if action_head_type == "mix":
        return MixActionHead(action_horizon, action_dim, kw)
    if action_head_type == "discrete":
        return DiscreteActionHead(action_horizon, action_dim,
                                  token_per=kw["discrete_token_type"])
    raise NotImplementedError(f"unknown action_head_type {action_head_type}")


def readout_token_count(action_head_type: str, action_head_kwargs: dict,
                        action_horizon: int, action_dim: int) -> int:
    """How many readout ("action") tokens the encoder appends: the discrete
    head reads one a unit of its token layout, the regression heads one a
    horizon step or one in all
    (hypervla_tpu/models/base_network.py::_readout_token_count)."""
    if action_head_type == "discrete":
        per = {"action_dim_and_action_horizon": action_horizon * action_dim,
               "action_horizon": action_horizon}
        return per[action_head_kwargs["discrete_token_type"]]
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


class OctoEncoder:
    """The Octo transformer as a generated base net's encoder, under
    "encoder/", with the shapes it was built for (input_shapes: the frame
    (H, W) and the instruction's (L, token_dim))."""

    has_trunk = False
    batched_encoder = False
    fine_tune = False
    use_language_token = False

    def __init__(self, octo_kwargs: dict, n_readout: int, encoder_type: str,
                 input_shapes: Optional[dict] = None):
        kw = octo_kwargs
        pretrained_tok = kw.get("use_pretrained_image_tokenizer", False)
        tokenizers = ({} if pretrained_tok else {
            k: ModuleSpec.instantiate(spec)()
            for k, spec in kw["observation_tokenizers"].items()})
        self.transformer = OctoTransformer(
            observation_tokenizers=tokenizers,
            readouts={"action": n_readout},
            transformer_kwargs=kw["transformer_kwargs"],
            token_embedding_size=kw["token_embedding_size"],
            max_horizon=kw["max_horizon"],
            repeat_task_tokens=kw["repeat_task_tokens"],
            use_correct_attention=True,
            use_pretrained_image_tokenizer=pretrained_tok,
            prefix="encoder")
        self.encoder_type = encoder_type
        self.hidden_dim = kw["token_embedding_size"]
        shapes = input_shapes or {}
        self.image = tuple(shapes.get("image", (224, 224)))
        self.instruction = tuple(shapes.get("instruction", (16, 768)))

    def __call__(self, params, observations, tasks, timestep_pad_mask,
                 draws=None):
        return self.transformer(params, observations, tasks,
                                timestep_pad_mask, draws=draws)

    def specs(self):
        length, dim = self.instruction
        observations = {
            "image_primary": np.zeros((1, 1, *self.image, 3), np.uint8),
            "timestep_pad_mask": np.ones((1, 1), bool)}
        tasks = {"language_instruction": {
                     "token_embedding": np.zeros((1, length, dim),
                                                 np.float32)},
                 "pad_mask_dict": {"language_instruction": np.ones(1, bool)}}
        return self.transformer.specs(observations, tasks)


class BaseNetwork:
    def __init__(self, model_type: str, action_head_type: str,
                 vit_kwargs: dict, action_head_kwargs: dict,
                 action_horizon: int = 4, action_dim: int = 7,
                 cnn_kwargs: Optional[dict] = None,
                 octo_kwargs: Optional[dict] = None,
                 input_shapes: Optional[dict] = None):
        """cnn_kwargs, which a JAX config carries, is read only by the
        model type that is not built (see the module docstring);
        octo_kwargs (the config's "model") by model_type "octo".
        input_shapes are the encoder's (models/base_vit.py::ViT)."""
        self.model_type = model_type
        if model_type == "cnn":
            raise TypeError(
                "model_type='cnn': BaseNetwork.encode calls its encoder with "
                "the instruction embeddings, train and image_embeddings, and "
                "CNN.__call__ takes the image alone (the JAX package's model "
                "raises this TypeError at init)")
        if model_type not in ("vit", "octo"):
            raise NotImplementedError(f"unknown model_type {model_type}")
        n_readout = readout_token_count(action_head_type, action_head_kwargs,
                                        action_horizon, action_dim)
        if model_type == "octo":
            self.encoder = OctoEncoder(octo_kwargs, n_readout,
                                       vit_kwargs["encoder_type"],
                                       input_shapes)
        else:
            self.encoder = ViT(vit_kwargs, n_readout, input_shapes)
        self.action_head = build_action_head(
            action_head_type, action_head_kwargs, action_horizon, action_dim)

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
        forward's dropout (and the diffusion head's steps and noise); maps
        (a dict) receives the policy transformer's attention maps
        (ViT.__call__)."""
        if self.model_type == "octo":
            task = dict(batch["task"])
            task["language_instruction"] = dict(
                task["language_instruction"],
                token_embedding=instruction_embeddings)
            outputs = self.encoder(params, batch["observation"], task,
                                   batch["observation"]["timestep_pad_mask"],
                                   draws)
            return self.action_head.loss(
                params, outputs["readout_action"], batch["action"],
                batch["observation"]["timestep_pad_mask"],
                batch["action_pad_mask"], draws)
        images = None
        if image_embeddings is None:
            images = _one_frame(batch["observation"]["image_primary"])
        tokens = self.encode(params, images, image_embeddings=image_embeddings,
                             instruction_embeddings=instruction_embeddings,
                             draws=draws, maps=maps)
        return self.action_head.loss(
            params, tokens, batch["action"],
            batch["observation"]["timestep_pad_mask"],
            batch["action_pad_mask"], draws)

    def predict_action(self, params: Dict[str, torch.Tensor], images,
                       trunk_impl: str = "kernel",
                       instruction_embeddings=None, maps=None, rng=None,
                       image_embeddings=None):
        """images (B, H, W, C) or (B, 1, H, W, C) uint8 -> action chunk
        (B, horizon, action_dim); maps (a dict) receives the attention
        maps (ViT.__call__). rng (a torch.Generator, or a
        models/draws.py::Draws to replay) is the diffusion head's, which
        raises without one; the other heads do not read it."""
        if self.model_type == "octo":
            raise TypeError("OctoTransformer.__call__() got an unexpected "
                            "keyword argument 'image_embeddings'")
        images = None if images is None else _one_frame(images)
        tokens = self.encode(params, images, trunk_impl,
                             image_embeddings=image_embeddings,
                             instruction_embeddings=instruction_embeddings,
                             maps=maps)
        return self.action_head.predict_action(params, tokens, as_draws(rng),
                                               argmax=True)

    def specs(self) -> Dict[str, Tuple[tuple, layers.Init]]:
        specs = self.encoder.specs()
        specs.update(self.action_head.specs(self.encoder.hidden_dim))
        return specs
