"""Data utilities (parity: octo/data/utils/data_utils.py) — numpy, no TF.

Statistics computation/caching, normalization schemes, and the gripper-action
relabeling family. The scan-style relabelers are vectorized (searchsorted /
forward-fill) instead of per-step tf.cond scans.

The port's copy of hypervla_tpu/data/data_utils.py: only its imports and
the statistics' fallback cache (~/.cache/hypervla_tpu_torch) differ.
"""
import hashlib
import json
import logging
import os
from enum import Enum
from fnmatch import fnmatch
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


def tree_map(fn: Callable, tree: dict) -> dict:
    return {
        k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
        for k, v in tree.items()
    }


def tree_merge(*trees: dict) -> dict:
    merged = {}
    for tree in trees:
        for k, v in tree.items():
            if isinstance(v, dict):
                merged[k] = tree_merge(merged.get(k, {}), v)
            else:
                merged[k] = v
    return merged


class NormalizationType(str, Enum):
    NORMAL = "normal"  # mean 0, std 1
    BOUNDS = "bounds"  # [-1, 1] from p01/p99


def to_padding(tensor: np.ndarray) -> np.ndarray:
    if tensor.dtype.kind in ("S", "U", "O"):
        return np.full(tensor.shape, b"", dtype=tensor.dtype)
    return np.zeros_like(tensor)


def sample_match_keys_uniform(d: dict, key_template: str, rng: np.random.Generator):
    """Samples uniformly from all keys fnmatching the template."""
    match_keys = [key for key in d.keys() if fnmatch(key, key_template)]
    if not match_keys:
        raise ValueError(f"No matching key found for {key_template}: {d.keys()}")
    if len(match_keys) > 1:
        idx = int(rng.integers(0, len(match_keys)))
        return d[match_keys[idx]]
    return d[match_keys[0]]


def pprint_data_mixture(dataset_kwargs_list, dataset_weights) -> None:
    print("#" * 86)
    print(
        f"# Loading the following {len(dataset_kwargs_list)} datasets "
        f"(incl. sampling weight):{'': >24} #"
    )
    for dataset_kwargs, weight in zip(dataset_kwargs_list, dataset_weights):
        pad = 80 - len(dataset_kwargs["name"])
        print(f"# {dataset_kwargs['name']}: {weight:=>{pad}f} #")
    print("#" * 86)


def get_dataset_statistics(
    traj_iterator,
    hash_dependencies: Tuple[str, ...],
    save_dir: Optional[str] = None,
    force_recompute: bool = False,
) -> dict:
    """Computes (or loads cached) action/proprio statistics over a trajectory
    iterator yielding dicts with "action" (+ optional "observation"/"proprio").
    Cache key = sha256 of hash_dependencies, identical scheme to the reference.
    """
    unique_hash = hashlib.sha256(
        "".join(hash_dependencies).encode("utf-8"), usedforsecurity=False
    ).hexdigest()
    local_path = os.path.expanduser(
        os.path.join("~", ".cache", "hypervla_tpu_torch",
                     f"dataset_statistics_{unique_hash}.json")
    )
    path = (
        os.path.join(save_dir, f"dataset_statistics_{unique_hash}.json")
        if save_dir is not None
        else local_path
    )

    for candidate in (path, local_path):
        if os.path.exists(candidate) and not force_recompute:
            logging.info(f"Loading existing dataset statistics from {candidate}.")
            with open(candidate) as f:
                return json.load(f)

    logging.info("Computing dataset statistics (cached for future runs).")

    def field_summary(stack):
        values = np.concatenate(stack)
        return {
            "mean": values.mean(0).tolist(),
            "std": values.std(0).tolist(),
            "max": values.max(0).tolist(),
            "min": values.min(0).tolist(),
            "p99": np.quantile(values, 0.99, 0).tolist(),
            "p01": np.quantile(values, 0.01, 0).tolist(),
        }

    actions, proprios = [], []
    num_transitions = num_trajectories = 0
    for traj in traj_iterator:
        actions.append(np.asarray(traj["action"]))
        obs = traj.get("observation", {})
        if "proprio" in obs:
            proprios.append(np.asarray(obs["proprio"]))
        elif "proprio" in traj:
            proprios.append(np.asarray(traj["proprio"]))
        num_transitions += traj["action"].shape[0]
        num_trajectories += 1
    metadata = {
        "action": field_summary(actions),
        "num_transitions": num_transitions,
        "num_trajectories": num_trajectories,
    }
    if proprios:
        metadata["proprio"] = field_summary(proprios)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(metadata, f)
    except OSError:
        logging.warning(f"Could not write statistics to {path}; using {local_path}.")
        os.makedirs(os.path.dirname(local_path), exist_ok=True)
        with open(local_path, "w") as f:
            json.dump(metadata, f)
    return metadata


def combine_dataset_statistics(all_dataset_statistics: Sequence[dict]) -> dict:
    """Merges statistics across datasets (transition-weighted pooled
    mean/variance, elementwise min/max)."""
    stats = all_dataset_statistics
    counts = np.array([s["num_transitions"] for s in stats])
    total = counts.sum()

    def pooled(key):
        means = np.array([s[key]["mean"] for s in stats])
        stds = np.array([s[key]["std"] for s in stats])
        mean = (means * (counts / total)[:, None]).sum(0)
        # law of total variance over the dataset partition
        var = (
            counts[:, None] * (stds**2 + (means - mean) ** 2)
        ).sum(0) / total
        return {
            "min": np.array([s[key]["min"] for s in stats]).min(0).tolist(),
            "max": np.array([s[key]["max"] for s in stats]).max(0).tolist(),
            "mean": mean.tolist(),
            "std": np.sqrt(var).tolist(),
        }

    combined = {
        key: pooled(key)
        for key in ("action", "proprio")
        if all(key in s for s in stats)
    }
    combined["num_trajectories"] = [s["num_trajectories"] for s in stats]
    combined["num_transitions"] = counts.tolist()
    return combined


def normalize_action_and_proprio(
    traj: dict, metadata: dict, normalization_type: NormalizationType
):
    """Normalizes traj["action"] and traj["observation"]["proprio"] in place
    (with optional per-dimension mask in the metadata)."""

    def _normal(x, meta):
        mask = np.asarray(
            meta.get("mask", np.ones_like(np.asarray(meta["mean"]), dtype=bool))
        )
        mean = np.asarray(meta["mean"], dtype=np.float32)
        std = np.asarray(meta["std"], dtype=np.float32)
        return np.where(mask, (x - mean) / (std + 1e-8), x).astype(np.float32)

    def _bounds(x, meta):
        mask = np.asarray(
            meta.get("mask", np.ones_like(np.asarray(meta["p01"]), dtype=bool))
        )
        p01 = np.asarray(meta["p01"], dtype=np.float32)
        p99 = np.asarray(meta["p99"], dtype=np.float32)
        scaled = np.clip(2 * (x - p01) / (p99 - p01 + 1e-8) - 1, -1, 1)
        return np.where(mask, scaled, x).astype(np.float32)

    fn = {
        NormalizationType.NORMAL: _normal,
        NormalizationType.BOUNDS: _bounds,
    }[NormalizationType(normalization_type)]

    traj["action"] = fn(np.asarray(traj["action"], np.float32), metadata["action"])
    if "proprio" in traj.get("observation", {}):
        traj["observation"]["proprio"] = fn(
            np.asarray(traj["observation"]["proprio"], np.float32),
            metadata["proprio"],
        )
    return traj


def binarize_gripper_actions(actions: np.ndarray) -> np.ndarray:
    """Relabels intermediate gripper values with the state reached AFTER them
    (reverse carry); a trailing intermediate chunk keeps the raw final action.
    Vectorized equivalent of the reference's reverse tf.scan
    (octo/data/utils/data_utils.py:296-333)."""
    actions = np.asarray(actions, dtype=np.float32)
    n = actions.shape[0]
    open_mask = actions > 0.95
    closed_mask = actions < 0.05
    in_between = ~(open_mask | closed_mask)
    is_open_float = open_mask.astype(np.float32)

    definite_idx = np.nonzero(~in_between)[0]
    # for each i, the first definite index >= i
    next_def = np.searchsorted(definite_idx, np.arange(n), side="left")
    new_actions = np.empty(n, dtype=np.float32)
    has_next = next_def < len(definite_idx)
    if len(definite_idx):
        safe = np.minimum(next_def, len(definite_idx) - 1)
        new_actions = np.where(
            has_next, is_open_float[definite_idx[safe]], actions[-1]
        )
    else:
        new_actions[:] = actions[-1]
    return new_actions


def rel_open_or_closed(actions: np.ndarray) -> np.ndarray:
    """Initial absolute gripper state from relative actions. NOTE: preserved
    reference quirk — both opening and closing map to -1 in the state mask
    (data_utils.py:345), so this always returns 0.0 when any change exists."""
    actions = np.asarray(actions, dtype=np.float32)
    opening_mask = actions > 1e-3
    closing_mask = actions < -1e-3
    old_state_mask = np.where(opening_mask, -1, np.where(closing_mask, -1, 0))
    carry = 0.0
    for i in range(actions.shape[0] - 1, -1, -1):
        if old_state_mask[i] != 0:
            carry = (float(old_state_mask[i]) + 1) / 2
    return np.float32(carry)


def rel2abs_gripper_actions(actions: np.ndarray) -> np.ndarray:
    """Relative (+close/-open) -> absolute (0 closed, 1 open) gripper actions
    via forward fill of thresholded changes."""
    actions = np.asarray(actions, dtype=np.float32)
    n = actions.shape[0]
    opening_mask = actions < -0.1
    closing_mask = actions > 0.1
    thresholded = np.where(opening_mask, 1, np.where(closing_mask, -1, 0))

    nonzero = np.nonzero(thresholded)[0]
    if len(nonzero):
        start = -thresholded[nonzero[0]]
        if start == 0:
            start = 1
    else:
        start = 1

    # forward-fill the last nonzero threshold (vectorized carry)
    filled_idx = np.maximum.accumulate(
        np.where(thresholded != 0, np.arange(n), -1)
    )
    new_actions = np.where(
        filled_idx >= 0, thresholded[np.maximum(filled_idx, 0)], start
    )
    return new_actions.astype(np.float32) / 2 + 0.5


def invert_gripper_actions(actions: np.ndarray):
    return 1 - actions


def relabel_actions(traj: Dict[str, Any]) -> Dict[str, Any]:
    """Replaces movement actions with reached-proprio deltas; drops the final
    timestep (no next state)."""
    movement_actions = (
        traj["observation"]["state"][1:, :6] - traj["observation"]["state"][:-1, :6]
    )
    truncated = tree_map(lambda x: x[:-1], traj)
    truncated["action"] = np.concatenate(
        [movement_actions, traj["action"][:-1, -1:]], axis=1
    )
    return truncated


def allocate_threads(n: Optional[int], weights: np.ndarray):
    """Allocates n worker threads across datasets proportionally to weights,
    at least 1 each. None -> "auto" sentinel (-1) per dataset."""
    if n is None:
        return np.array([-1] * len(weights))
    assert np.all(weights >= 0), "Weights must be non-negative"
    assert len(weights) <= n, "Need at least one thread per dataset"
    weights = np.array(weights) / np.sum(weights)

    allocation = np.zeros_like(weights, dtype=int)
    # datasets too small for one proportional thread get exactly one, and
    # the remainder is re-split among the rest until stable
    while True:
        starved = (weights * n < 1) & (weights > 0)
        if not starved.any():
            break
        allocation += starved.astype(int)
        n -= starved.sum()
        weights = np.where(starved, 0, weights)
        weights = weights / weights.sum()
    fractional, integral = np.modf(weights * n)
    allocation += integral.astype(int)
    leftover = int(n - integral.sum())
    allocation[np.argsort(fractional)[::-1][:leftover]] += 1
    return allocation
