"""The OXE registry: the port's copy of hypervla_tpu/data/oxe/. The
standardize_fn ModuleSpecs name the port's own functions."""
from hypervla_tpu_torch.data.oxe.registry import (
    make_oxe_dataset_kwargs,
    make_oxe_dataset_kwargs_and_weights,
)
