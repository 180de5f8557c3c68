"""Synthetic OXE mix registration, for pipeline benchmarks and tests.

Registers N fixture datasets (standard npz/RLDS layout, identity
standardization) plus a named mix in the real OXE registries, so the full
named-mix path — mix expansion, per-dataset kwargs, standardize_fn
ModuleSpecs, weights + balance, per-dataset statistics, interleave — runs
exactly as it would for `oxe_magic_soup` (reference:
octo/data/dataset.py:566-674) without needing the real OXE corpora.
"""
from typing import Any, Dict, List, Optional, Sequence, Tuple

from hypervla_tpu_torch.data.oxe.oxe_dataset_configs import (
    ActionEncoding,
    OXE_DATASET_CONFIGS,
    ProprioEncoding,
)
from hypervla_tpu_torch.data.oxe.oxe_dataset_mixes import OXE_NAMED_MIXES
from hypervla_tpu_torch.data.oxe.oxe_standardization_transforms import (
    OXE_STANDARDIZATION_TRANSFORMS,
)


def fixture_dataset_transform(trajectory: Dict[str, Any]) -> Dict[str, Any]:
    """Fixture datasets are already in the standard layout."""
    return trajectory


def dataset_name(i: int) -> str:
    return f"fixture_mix_ds_{i}"


def register_fixture_mix(
    n: int, weights: Optional[Sequence[float]] = None
) -> Tuple[str, List[float]]:
    """Registers n fixture datasets + a named mix; returns (mix_name, weights).

    Default weights alternate 1.0 / 2.0 / 0.5 so the weighted-interleave math
    is exercised with a non-uniform distribution.
    """
    if weights is None:
        weights = [(1.0, 2.0, 0.5)[i % 3] for i in range(n)]
    assert len(weights) == n
    for i in range(n):
        name = dataset_name(i)
        OXE_DATASET_CONFIGS[name] = {
            "image_obs_keys": {"primary": "image", "secondary": None,
                               "wrist": None},
            "depth_obs_keys": {"primary": None, "secondary": None,
                               "wrist": None},
            "proprio_encoding": ProprioEncoding.NONE,
            "action_encoding": ActionEncoding.EEF_POS,
        }
        OXE_STANDARDIZATION_TRANSFORMS[name] = fixture_dataset_transform
    mix_name = f"fixture_mix_{n}"
    OXE_NAMED_MIXES[mix_name] = [
        (dataset_name(i), float(weights[i])) for i in range(n)
    ]
    return mix_name, list(weights)
