"""Pretrained encoder weights (counterpart of
hypervla_tpu/models/encoders/pretrained.py): the T5 that the text encoder,
the trainer and the Octo LanguageTokenizer read, the frozen DINOv2 of the
trainer, and the CLIP trunk of a CLIP policy.

The JAX package searches $HYPERVLA_PRETRAINED_DIR for flax msgpack dumps
and the HuggingFace cache for Flax checkpoints; both need flax or
transformers, which the GPU host lacks. The port reads only its own
format: `<name>.pt` under $HYPERVLA_PRETRAINED_DIR, a flat {name: tensor}
dict in the keys of models/encoders/t5.py, dinov2.py or clip.py (the JAX trainer's
_find_msgpack looks in the same directory). Where there is none (no such
file is in the repository) the loader returns None and the caller keeps a
random init, as the JAX package does.
"""
import logging
import os
from pathlib import Path
from typing import Dict, Optional

import torch


def _load(name: str, device, what: str
          ) -> Optional[Dict[str, torch.Tensor]]:
    root = os.environ.get("HYPERVLA_PRETRAINED_DIR")
    path = Path(root) / f"{name}.pt" if root else None
    if path is None or not path.exists():
        logging.warning(f"No pretrained weights for {name} found; the "
                        f"{what} will use random init.")
        return None
    return torch.load(path, map_location=device, weights_only=True)


def load_t5_weights(name: str = "t5-base", device=None
                    ) -> Optional[Dict[str, torch.Tensor]]:
    """The T5 encoder's flat params from `<name>.pt`, or None."""
    return _load(name, device, "language encoder")


def load_dinov2_weights(name: str = "dinov2-base", device=None
                        ) -> Optional[Dict[str, torch.Tensor]]:
    """The DINOv2 encoder's flat params (models/encoders/dinov2.py's keys
    without a prefix) from `<name>.pt`, or None."""
    return _load(name, device, "frozen image encoder")


def load_clip_weights(name: str = "clip-vit-base-patch16", device=None
                      ) -> Optional[Dict[str, torch.Tensor]]:
    """The CLIP vision trunk's flat params (models/encoders/clip.py's keys,
    "vision_model/..."), from `<name>.pt`, or None."""
    return _load(name, device, "CLIP image encoder")
