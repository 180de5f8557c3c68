"""The frozen encoders of the training step (counterpart of
hypervla_tpu/train/trainer.py::build_frozen_encoders).

Pretrained T5 and DINOv2 weights are not in the repository, so both
encoders are drawn from a seed of their own, as the JAX trainer inits them
when no weights load; the DINOv2 conditioning encoder's params are separate
from the (fine-tuned) trunk's. The data pipeline, `train()`'s loop,
callbacks and checkpoints are not ported (ROADMAP.md A2).
"""
from typing import Any, Dict

import torch

from hypervla_tpu_torch.configs import dinov2_config
from hypervla_tpu_torch.models.base_vit import normalize_pixels
from hypervla_tpu_torch.models.encoders.dinov2 import (
    dinov2_forward,
    dinov2_specs,
    pack_frozen_layers,
)
from hypervla_tpu_torch.models.encoders.t5 import (
    t5_config,
    t5_encode,
    t5_specs,
)


def _init(specs, seed: int, device):
    gen = torch.Generator().manual_seed(seed)
    return {name: init(shape, gen).float().to(device)
            for name, (shape, init) in specs.items()}


def frozen_layer_kernel(config: Dict[str, Any]) -> bool:
    """Whether the frozen DINOv2's layers take the no-residual layer
    forward (ops/dino_layer_train.py): asked for (frozen_encoder_layer_kernel
    or dino_layers_impl="pallas_train"), a bf16 encoder and a width that is
    a multiple of 128, as the JAX trainer decides."""
    vk = config["base_net_kwargs"]["vit_kwargs"]
    name = vk.get("pretrained_encoder_name", "dinov2-base")
    return bool(
        (config.get("frozen_encoder_layer_kernel", False)
         or vk.get("dino_layers_impl") == "pallas_train")
        and vk.get("encoder_dtype") == "bfloat16"
        and dinov2_config(name).hidden_size % 128 == 0)


def build_frozen_encoders(config: Dict[str, Any], device="cpu",
                          seed: int = 0):
    """Returns (text_apply, dino_apply, t5_params, dino_params):
    text_apply(t5_params, input_ids, attention_mask) -> fp32 token
    embeddings; dino_apply(dino_params, uint8 images (B, H, W, 3)) -> fp32
    last_hidden_state (B, 1 + patches, width). T5 params are drawn from
    `seed`, DINOv2's from `seed + 1`; on the layer forward's route
    (frozen_layer_kernel) dino_params hold each layer's operands packed
    once. dino_apply is None without initial-image conditioning."""
    tok = config["dataset_kwargs"].get("text_tokenizer", "t5-base")
    t5 = t5_config(tok)
    t5_params = _init(t5_specs(t5), seed, device)

    def text_apply(params, input_ids, attention_mask):
        return t5_encode(t5, params, input_ids, attention_mask)

    if not config["hypernet_kwargs"].get("use_initial_image", False):
        return text_apply, None, t5_params, None
    vk = config["base_net_kwargs"]["vit_kwargs"]
    dino = dinov2_config(vk.get("pretrained_encoder_name", "dinov2-base"))
    specs = dinov2_specs(dino, "dino")
    dino_params = {k[len("dino/"):]: v
                   for k, v in _init(specs, seed + 1, device).items()}
    dtype = (torch.bfloat16 if vk.get("encoder_dtype") == "bfloat16"
             else torch.float32)
    layer_kernel = frozen_layer_kernel(config)
    if layer_kernel:
        dino_params = pack_frozen_layers(dino, dino_params)

    def dino_apply(params, images):
        return dinov2_forward(dino, params, normalize_pixels(images), dtype,
                              layer_kernel=layer_kernel)

    return text_apply, dino_apply, t5_params, dino_params
