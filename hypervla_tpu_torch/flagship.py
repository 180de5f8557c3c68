"""The flagship model (counterpart of hypervla_tpu/flagship.py): the
README vit_t,oxe recipe at full width: DINOv2-base shared image encoder
(12 layers, width 768) with a bf16 serving trunk, 6-layer/128-wide context
encoder, 4-layer/64-wide generated policy ViT, mix action head. Weights
are random, drawn from a seed (pretrained DINOv2 and T5 files are not in
the repository)."""
from typing import Optional

import numpy as np
import torch

from hypervla_tpu_torch.configs import flagship_pretrain_config
from hypervla_tpu_torch.models.hypervla import HyperVLA

INSTR_LEN, TOKEN_DIM = 32, 768  # the T5-base token embedding the hypernet reads


def make_flagship_batch(seed: int = 0, instr_len: int = INSTR_LEN,
                        initial_patch_dim: int = 768) -> dict:
    """A one-task example batch with the flagship's shapes."""
    rng = np.random.default_rng(seed)
    return {
        "task": {
            "language_instruction": {
                "token_embedding": rng.standard_normal(
                    (1, instr_len, TOKEN_DIM)).astype(np.float32),
                "attention_mask": np.ones((1, instr_len), np.int32),
            },
        },
        "initial_state": {
            # 256 DINOv2 patches + the CLS token
            "patch_embeddings": rng.standard_normal(
                (1, 257, initial_patch_dim)).astype(np.float32),
        },
    }


def build_flagship(seed: int = 0, device="cpu",
                   encoder_dtype: str = "bfloat16",
                   dataset_statistics: Optional[dict] = None):
    """Returns (model, example_batch) on `device`."""
    config = flagship_pretrain_config()
    config["base_net_kwargs"]["vit_kwargs"]["encoder_dtype"] = encoder_dtype
    batch = make_flagship_batch(seed)
    model = HyperVLA.from_config(config, batch, seed=seed,
                                 dataset_statistics=dataset_statistics,
                                 device=torch.device(device))
    return model, batch
