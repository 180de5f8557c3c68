"""Goal relabeling (parity: octo/data/utils/goal_relabeling.py) — numpy.

Each function adds entries to the "task" dict. The goal observation carries
its "timestep" field into the task (the observation gains a timestep index in
the loader), which downstream chunking uses as the goal timestep.

The port's copy of hypervla_tpu/data/goal_relabeling.py: only its imports differ.
"""
from typing import Optional

import numpy as np

from hypervla_tpu_torch.data.data_utils import tree_map, tree_merge


def uniform(traj: dict, max_goal_distance: Optional[int] = None,
            rng: Optional[np.random.Generator] = None) -> dict:
    """Relabels each frame's goal with a uniformly sampled future state."""
    rng = rng or np.random.default_rng()
    traj_len = traj["action"].shape[0]

    rand = rng.random(traj_len)
    low = np.arange(traj_len, dtype=np.float64)
    if max_goal_distance is not None:
        high = np.minimum(np.arange(traj_len) + max_goal_distance,
                          traj_len).astype(np.float64)
    else:
        high = np.full(traj_len, float(traj_len))
    goal_idxs = (rand * (high - low) + low).astype(np.int64)
    goal_idxs = np.minimum(goal_idxs, traj_len - 1)

    goal = tree_map(lambda x: x[goal_idxs], traj["observation"])
    traj["task"] = tree_merge(traj.get("task", {}), goal)
    return traj
