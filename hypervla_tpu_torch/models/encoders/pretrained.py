"""Pretrained encoder weights (counterpart of
hypervla_tpu/models/encoders/pretrained.py), the T5 part that the text
encoder reads.

The JAX package searches $HYPERVLA_PRETRAINED_DIR for flax msgpack dumps
and the HuggingFace cache for Flax checkpoints; both need flax or
transformers, which the GPU host lacks. The port reads only its own
format: `<name>.pt` under $HYPERVLA_PRETRAINED_DIR, a flat {name: tensor}
dict in the keys of models/encoders/t5.py. Where there is none (no such
file is in the repository) the loader returns None and the caller keeps a
random init, as the JAX package does.
"""
import logging
import os
from pathlib import Path
from typing import Dict, Optional

import torch


def load_t5_weights(name: str = "t5-base", device=None
                    ) -> Optional[Dict[str, torch.Tensor]]:
    """The T5 encoder's flat params from `<name>.pt`, or None."""
    root = os.environ.get("HYPERVLA_PRETRAINED_DIR")
    path = Path(root) / f"{name}.pt" if root else None
    if path is None or not path.exists():
        logging.warning(f"No pretrained weights for {name} found; the "
                        "language encoder will use random init.")
        return None
    return torch.load(path, map_location=device, weights_only=True)
