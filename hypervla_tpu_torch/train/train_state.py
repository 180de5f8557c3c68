"""TrainState (counterpart of hypervla_tpu/train/train_state.py): the step
counter, the params as fp32 leaf tensors that carry gradients, the
optimizer state, the EMA of the params, a real copy of its own, and the
seed the step's random draws (device augmentation) derive from, with the
step, where the JAX state carries a PRNG key."""
import dataclasses
from typing import Any, Dict, Optional

import torch

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    step: int
    params: Params
    opt_state: Any
    ema_params: Optional[Params] = None
    seed: int = 0

    @classmethod
    def create(cls, params: Params, tx, track_ema: bool = False,
               seed: int = 0) -> "TrainState":
        params = {k: v.detach().clone().float().requires_grad_(True)
                  for k, v in params.items()}
        ema = ({k: v.detach().clone() for k, v in params.items()}
               if track_ema else None)
        return cls(step=0, params=params, opt_state=tx.init(params),
                   ema_params=ema, seed=seed)
