"""OXE dataset kwargs construction (parity: octo/data/oxe/__init__.py)."""
import copy
import logging
from typing import Any, Dict, List, Sequence, Tuple, Union

from hypervla_tpu_torch.data.data_utils import NormalizationType
from hypervla_tpu_torch.data.oxe.oxe_dataset_configs import (
    ActionEncoding,
    OXE_DATASET_CONFIGS,
)
from hypervla_tpu_torch.data.oxe.oxe_dataset_mixes import OXE_NAMED_MIXES
from hypervla_tpu_torch.data.oxe.oxe_standardization_transforms import (
    OXE_STANDARDIZATION_TRANSFORMS,
)
from hypervla_tpu_torch.utils.spec import ModuleSpec

# datasets whose language annotations are uninformative/absent; skipped when
# skip_unlabeled is requested
DATASET_WO_INSTRUCTION = [
    "kuka",
    "berkeley_cable_routing",
    "roboturk",
    "nyu_door_opening_surprising_effectiveness",
    "viola",
    "toto",
    "stanford_hydra_dataset_converted_externally_to_rlds",
    "austin_buds_dataset_converted_externally_to_rlds",
    "nyu_franka_play_dataset_converted_externally_to_rlds",
    "austin_sailor_dataset_converted_externally_to_rlds",
    "austin_sirius_dataset_converted_externally_to_rlds",
    "utaustin_mutex",
]

# action-normalization mask per encoding: gripper/absolute dims stay raw
_NORMALIZATION_MASKS = {
    ActionEncoding.EEF_POS: [True] * 6 + [False],
    ActionEncoding.JOINT_POS: [True] * 7 + [False],
    ActionEncoding.JOINT_POS_BIMANUAL: [True] * 6 + [False] + [True] * 6
    + [False],
    ActionEncoding.NAV_2D: [True] * 2,
    ActionEncoding.JOINT_POS_BIMANUAL_NAV: [True] * 6 + [False] + [True] * 6
    + [False] + [True] * 2,
}


def make_oxe_dataset_kwargs(
    name: str,
    data_dir: str,
    load_camera_views: Sequence[str] = ("primary",),
    load_depth: bool = False,
    load_proprio: bool = False,
    load_language: bool = True,
    force_recompute_dataset_statistics: bool = False,
    action_proprio_normalization_type: NormalizationType = NormalizationType.NORMAL,
    add_initial_image: bool = False,
) -> Dict[str, Any]:
    """Builds kwargs for `make_dataset_from_rlds` for one OXE dataset."""
    dataset_kwargs = copy.deepcopy(OXE_DATASET_CONFIGS[name])

    encoding = dataset_kwargs["action_encoding"]
    if encoding not in _NORMALIZATION_MASKS:
        raise ValueError(
            f"Cannot load {name} with unsupported action encoding {encoding}."
        )
    dataset_kwargs["action_normalization_mask"] = _NORMALIZATION_MASKS[encoding]

    missing_keys = set(load_camera_views) - set(dataset_kwargs["image_obs_keys"])
    if missing_keys:
        raise ValueError(
            f"Cannot load {name} with views {missing_keys}: not available."
        )
    dataset_kwargs["image_obs_keys"] = {
        k: v
        for k, v in dataset_kwargs["image_obs_keys"].items()
        if k in load_camera_views
    }
    dataset_kwargs["depth_obs_keys"] = {
        k: v
        for k, v in dataset_kwargs["depth_obs_keys"].items()
        if k in load_camera_views
    }

    if not load_depth:
        dataset_kwargs.pop("depth_obs_keys")
    if load_proprio:
        dataset_kwargs["proprio_obs_key"] = "proprio"
    if load_language:
        dataset_kwargs["language_key"] = "language_instruction"

    dataset_kwargs["action_proprio_normalization_type"] = (
        action_proprio_normalization_type
    )
    del dataset_kwargs["proprio_encoding"]
    del dataset_kwargs["action_encoding"]

    dataset_kwargs["standardize_fn"] = ModuleSpec.create(
        OXE_STANDARDIZATION_TRANSFORMS[name]
    )
    if force_recompute_dataset_statistics:
        dataset_kwargs["force_recompute_dataset_statistics"] = True
    dataset_kwargs["add_initial_image"] = add_initial_image

    return {"name": name, "data_dir": data_dir, **dataset_kwargs}


def make_oxe_dataset_kwargs_and_weights(
    data_mix: Union[str, Sequence[Tuple[str, float]]],
    data_dir: str,
    load_camera_views: Sequence[str] = ("primary",),
    load_depth: bool = False,
    load_proprio: bool = False,
    load_language: bool = True,
    force_recompute_dataset_statistics: bool = False,
    action_proprio_normalization_type: NormalizationType = NormalizationType.NORMAL,
    skip_unlabeled: bool = False,
    add_initial_image: bool = False,
) -> Tuple[List[Dict[str, Any]], List[float]]:
    """Expands a named or explicit mix into (dataset_kwargs_list, weights)
    suitable for `make_interleaved_dataset`."""
    if isinstance(data_mix, str):
        data_mix = OXE_NAMED_MIXES[data_mix]

    filtered, included = [], set()
    for name, weight in data_mix:
        if skip_unlabeled and name in DATASET_WO_INSTRUCTION:
            logging.info(f"skip {name}: no language instructions")
            continue
        if name in included:
            logging.warning(f"Skipping duplicate: {(name, weight)}.")
            continue
        filtered.append((name, weight))
        included.add(name)

    data_kwargs_list, weights = [], []
    for name, weight in filtered:
        try:
            data_kwargs_list.append(
                make_oxe_dataset_kwargs(
                    name,
                    data_dir,
                    load_camera_views,
                    load_depth,
                    load_proprio,
                    load_language,
                    force_recompute_dataset_statistics,
                    action_proprio_normalization_type,
                    add_initial_image,
                )
            )
            weights.append(weight)
        except ValueError as e:
            logging.warning(f"Skipping {name} due to error: {e}")
    return data_kwargs_list, weights
