"""Trajectory-level transforms — pure numpy.

Capability parity with octo/data/traj_transforms.py. Each transform takes a
trajectory dict whose arrays share the leading trajectory-length axis.

The port's copy of hypervla_tpu/data/traj_transforms.py: only its imports differ.
"""
from typing import Optional

import numpy as np

from hypervla_tpu_torch.data.data_utils import tree_map


def _history_grid(traj_len: int, window_size: int):
    """[traj_len, window_size] gather indices looking back in time, plus the
    validity mask for positions before the episode start (clamped to 0)."""
    offsets = np.arange(1 - window_size, 1)
    grid = np.arange(traj_len)[:, None] + offsets
    return np.maximum(grid, 0), grid >= 0


def _future_chunk(actions: np.ndarray, horizon: int) -> np.ndarray:
    """[t, ...] actions -> [t, horizon, ...] future chunks. Pre-chunked
    inputs (ndim 3) are truncated; flat inputs gather with clamping at the
    episode end."""
    traj_len = actions.shape[0]
    if actions.ndim != 2:
        if actions.shape[1] < horizon:
            raise ValueError(
                f"action_horizon ({horizon}) > pre-chunked dim "
                f"({actions.shape[1]})"
            )
        return actions[:, :horizon]
    gather = np.minimum(
        np.arange(traj_len)[:, None] + np.arange(horizon), traj_len - 1
    )
    return actions[gather]


def chunk_act_obs(traj: dict, window_size: int = 1,
                  action_horizon: int = 1) -> dict:
    """Chunks observations into [traj_len, window_size, ...] histories and
    actions into [traj_len, window_size, action_horizon, action_dim] chunks,
    with timestep/action pad masks and the task_completed goal-distance
    flag."""
    traj_len = traj["action"].shape[0]
    history, valid = _history_grid(traj_len, window_size)

    traj["observation"] = tree_map(lambda x: x[history], traj["observation"])
    traj["observation"]["timestep_pad_mask"] = valid

    traj["action"] = _future_chunk(traj["action"], action_horizon)[history]

    task = traj.get("task", {})
    goal_timestep = (
        task["timestep"] if "timestep" in task
        else np.full([traj_len], traj_len - 1)
    )
    # absolute timestep each (window, horizon) cell refers to, offset by
    # the window-size convention the reference uses
    cell_t = (
        np.arange(traj_len)[:, None, None]
        + np.arange(window_size)[None, :, None]
        + np.arange(action_horizon)[None, None, :]
        - (window_size + 1)
    )
    completed = goal_timestep[:, None, None] - cell_t <= 0
    traj["observation"]["task_completed"] = completed

    apm = traj["action_pad_mask"]
    apm = apm[:, None, None, :] if apm.ndim == 2 else apm[:, None, :]
    traj["action_pad_mask"] = np.logical_and(apm, ~completed[..., None])
    return traj


def subsample(traj: dict, subsample_length: int,
              rng: Optional[np.random.Generator] = None) -> dict:
    """Uniformly subsamples the trajectory to subsample_length frames."""
    rng = rng or np.random.default_rng()
    traj_len = traj["action"].shape[0]
    if traj_len > subsample_length:
        keep = rng.permutation(traj_len)[:subsample_length]
        traj = tree_map(lambda x: x[keep], traj)
    return traj


def _string_lengths(arr: np.ndarray) -> np.ndarray:
    flat = [len(x) if x is not None else 0 for x in arr.reshape(-1)]
    return np.array(flat).reshape(arr.shape)


def add_pad_mask_dict(traj: dict) -> dict:
    """Adds per-key padding indicators under each top-level group: string
    keys (serialized images / language) are padding iff empty; everything
    else is always real."""
    traj_len = traj["action"].shape[0]
    for group in ("observation", "task", "initial_state"):
        if group not in traj:
            continue
        masks = {}
        for name, arr in traj[group].items():
            is_stringy = (
                isinstance(arr, np.ndarray)
                and arr.dtype.kind in ("S", "U", "O")
            )
            masks[name] = (
                _string_lengths(arr) != 0 if is_stringy
                else np.ones([traj_len], dtype=bool)
            )
        traj[group]["pad_mask_dict"] = masks
    return traj


def _pad_last_dim(arr: np.ndarray, target: int, what: str) -> np.ndarray:
    have = arr.shape[-1]
    if have > target:
        raise ValueError(f"{what}_dim ({have}) > max_{what}_dim ({target})")
    widths = [[0, 0]] * (arr.ndim - 1) + [[0, target - have]]
    return np.pad(arr, widths)


def pad_actions_and_proprio(
    traj: dict, max_action_dim: Optional[int],
    max_proprio_dim: Optional[int],
) -> dict:
    """Zero-pads action/proprio dims to dataset-mix-wide maxima and records
    which dims are real in "action_pad_mask"."""
    traj["action_pad_mask"] = np.ones_like(traj["action"], dtype=bool)
    if max_action_dim is not None:
        for key in ("action", "action_pad_mask"):
            traj[key] = _pad_last_dim(traj[key], max_action_dim, "action")
    if max_proprio_dim is not None and "proprio" in traj.get(
        "observation", {}
    ):
        traj["observation"]["proprio"] = _pad_last_dim(
            traj["observation"]["proprio"], max_proprio_dim, "proprio"
        )
    return traj
