"""The flagship model (counterpart of hypervla_tpu/flagship.py): the
README vit_t,oxe recipe at full width: DINOv2-base shared image encoder
(12 layers, width 768), 6-layer/128-wide context encoder, 4-layer/64-wide
generated policy ViT, mix action head; or its tiny topological twin for CPU
tests. Weights are random, drawn from a seed (pretrained DINOv2 and T5
files are not in the repository)."""
from typing import Optional

import numpy as np

from hypervla_tpu_torch.configs import (
    disable_unused_attention_capture,
    flagship_pretrain_config,
    tiny_test_config,
)
from hypervla_tpu_torch.models.hypervla import HyperVLA


def make_flagship_batch(
    batch_size: int = 1,
    instr_len: int = 32,
    image_size: int = 224,
    action_horizon: int = 4,
    action_dim: int = 7,
    token_dim: int = 768,
    initial_patch_dim: int = 768,
    seed: int = 0,
) -> dict:
    """A batch with the flagship's keys and shapes; the same values as the
    JAX package's make_flagship_batch for the same arguments."""
    rng = np.random.RandomState(seed)
    return {
        "observation": {
            "image_primary": rng.randint(
                0, 255, (batch_size, 1, image_size, image_size, 3)
            ).astype(np.uint8),
            "timestep_pad_mask": np.ones((batch_size, 1), dtype=bool),
        },
        "task": {
            "language_instruction": {
                "input_ids": rng.randint(
                    2, 1000, (batch_size, instr_len)).astype(np.int32),
                "attention_mask": np.ones((batch_size, instr_len),
                                          dtype=np.int32),
                "token_embedding": rng.randn(
                    batch_size, instr_len, token_dim).astype(np.float32),
            },
            "pad_mask_dict": {
                "language_instruction": np.ones(batch_size, dtype=bool)
            },
        },
        "action": rng.randn(
            batch_size, 1, action_horizon, action_dim).astype(np.float32),
        "action_pad_mask": np.ones(
            (batch_size, 1, action_horizon, action_dim), dtype=bool),
        "initial_state": {
            # 256 DINOv2 patches + the CLS token
            "image_primary": rng.randint(
                0, 255, (batch_size, 1, image_size, image_size, 3)
            ).astype(np.uint8),
            "patch_embeddings": rng.randn(
                batch_size, 257, initial_patch_dim).astype(np.float32),
        },
    }


def build_flagship(tiny: bool = False, seed: int = 0,
                   encoder_dtype: Optional[str] = None,
                   serving: bool = False, training: bool = False,
                   vit_overrides: Optional[dict] = None, device=None,
                   dataset_statistics: Optional[dict] = None):
    """Returns (model, example_batch) on `device` (None: the CUDA card, see
    utils/device.py::resolve_device), with the JAX builder's parameters and
    defaults: encoder_dtype None keeps the config's own trunk type
    (float32); `serving` turns the trunk's flash attention and attention
    capture off (the JAX builder's per-step serving path); `vit_overrides`
    updates the config's vit_kwargs last."""
    if tiny:
        config = tiny_test_config()
        batch = make_flagship_batch(instr_len=8, action_horizon=2,
                                    initial_patch_dim=32, seed=seed)
    else:
        config = flagship_pretrain_config()
        batch = make_flagship_batch(seed=seed)
    vk = config["base_net_kwargs"]["vit_kwargs"]
    if encoder_dtype is not None:
        vk["encoder_dtype"] = encoder_dtype
    if training:
        disable_unused_attention_capture(config)
    if serving:
        vk.update(use_flash_attention=False, sow_dino_attention=False)
    if vit_overrides:
        vk.update(vit_overrides)
    model = HyperVLA.from_config(config, batch, seed=seed,
                                 dataset_statistics=dataset_statistics,
                                 device=device)
    return model, batch
