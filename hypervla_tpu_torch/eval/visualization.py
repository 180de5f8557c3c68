"""Offline policy-vs-dataset visualization and metrics (counterpart of
hypervla_tpu/eval/visualization.py; numpy only, matplotlib imported only
for the plots).

Runs a policy over held-out trajectories, unnormalizes, and computes the
manipulation metrics logged to wandb (gripper correctness, xyz direction
angle and closeness, per-dimension MSE); RolloutVisualizer runs closed-loop
rollouts in a gym-style environment.
"""
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np


def unnormalize(arr, mean, std, mask=None, **kwargs):
    mean = np.asarray(mean)
    std = np.asarray(std)
    if mask is None:
        mask = np.ones_like(mean, dtype=bool)
    return np.where(mask, arr * std + mean, arr)


def run_policy_on_trajectory(policy_fn, traj, *, text_processor=None):
    """Applies policy_fn to every frame of a chunked trajectory dict; returns
    the trajectory augmented with predicted actions."""
    tasks = dict(traj["task"])
    if text_processor is not None and not isinstance(
        tasks.get("language_instruction"), dict
    ):
        tasks["language_instruction"] = text_processor.encode(
            [
                s.decode("utf-8") if isinstance(s, bytes) else str(s)
                for s in tasks["language_instruction"]
            ]
        )
    pred_actions = policy_fn(traj["observation"], tasks)
    return {
        **traj,
        "pred_actions": np.asarray(pred_actions),
    }


# ------------------------- manipulation metrics -------------------------


def _get_gripper(actions):
    return actions[..., -1]


def _get_xyz(actions):
    return actions[..., :3]


def _gripper_closed(actions):
    return _get_gripper(actions) < 0.5


def _gripper_correct(unnorm_actions, unnorm_pred_actions, **kwargs):
    return _gripper_closed(unnorm_actions) == _gripper_closed(
        unnorm_pred_actions
    )


def _xyz_angle(unnorm_actions, unnorm_pred_actions, **kwargs):
    def angle_between(v1, v2):
        v1_u = v1 / np.maximum(np.linalg.norm(v1, axis=-1, keepdims=True),
                               1e-12)
        v2_u = v2 / np.maximum(np.linalg.norm(v2, axis=-1, keepdims=True),
                               1e-12)
        return np.arccos(np.clip(np.sum(v1_u * v2_u, axis=-1), -1.0, 1.0))

    return angle_between(_get_xyz(unnorm_actions),
                         _get_xyz(unnorm_pred_actions))


def _xyz_close(unnorm_actions, unnorm_pred_actions, **kwargs):
    """Reference semantics: direction within 0.5 rad AND magnitudes within
    2x of each other (octo/utils/visualization_lib.py:631-640)."""
    norm_true = np.linalg.norm(_get_xyz(unnorm_actions), axis=-1)
    norm_pred = np.linalg.norm(_get_xyz(unnorm_pred_actions), axis=-1)
    angle = _xyz_angle(unnorm_actions=unnorm_actions,
                       unnorm_pred_actions=unnorm_pred_actions)
    return (
        (angle < 0.5)
        & (norm_true > 0.5 * norm_pred)
        & (norm_pred > 0.5 * norm_true)
    )


def _mse(actions, pred_actions, dims=None, **kwargs):
    delta = actions - pred_actions
    if dims is not None:
        delta = delta[..., dims]
    return np.sum(delta**2, axis=-1)


def _moving(unnorm_actions, axis=None, magnitude=0.0, **kwargs):
    if axis is None:
        return (
            np.linalg.norm(_get_xyz(unnorm_actions), axis=-1) > magnitude
        )
    return np.abs(unnorm_actions[..., axis]) > magnitude


def _xyz_info(**kwargs):
    """Translation-direction quality: angle between predicted and dataset
    xyz deltas, thresholded accuracy, and absolute closeness."""
    angle = _xyz_angle(**kwargs)
    return {
        "xyz_angle": angle,
        "xyz_angle_accuracy": angle < 0.5,
        "xyz_accuracy": _xyz_close(**kwargs),
    }


def _mse_info(actions, pred_actions, **kwargs):
    """Normalized-action MSE, total and per standard dimension group
    (xyz translation / xyz rotation / gripper)."""
    groups = {
        "mse": None,
        "mse_xyz": [0, 1, 2],
        "mse_xyzrotation": [3, 4, 5],
        "mse_gripper": [6],
    }
    return {
        name: _mse(actions, pred_actions, dims=dims)
        for name, dims in groups.items()
    }


def _gripper_info(unnorm_actions, **kwargs):
    """Gripper phase flags: transitioning toward closed ("gripping"),
    toward open ("releasing"), either, or neither — each timestep judged
    against a +-3-step neighborhood — plus per-step correctness."""
    closed = _gripper_closed(unnorm_actions)
    closed_past = np.roll(closed, 3, axis=0)
    closed_future = np.roll(closed, -3, axis=0)
    gripping = (closed & ~closed_past) | (closed_future & ~closed)
    releasing = (closed_past & ~closed) | (closed & ~closed_future)
    changing = gripping | releasing
    return {
        "gripper_correct": _gripper_correct(
            unnorm_actions=unnorm_actions, **kwargs
        ),
        "gripping": gripping,
        "releasing": releasing,
        "gripper_changing": changing,
        "still": ~changing,
    }


def _gripping_early_metrics(unnorm_actions, unnorm_pred_actions,
                            unnorm_proprio=None, **kwargs):
    """Did the policy close the gripper early relative to the dataset?
    Looks back up to 4 steps from each first-grip timestep; when proprio is
    available, also gates on the arm having been >=5mm higher (the
    height-aware variant) and reports the height/steps-to-grip.

    Grip timing is about the EXECUTED action — chunked [T, horizon, D]
    actions are reduced to their first horizon step so every quantity here
    is per-timestep [T] (matching the per-step proprio)."""
    if np.asarray(unnorm_actions).ndim == 3:
        unnorm_actions = np.asarray(unnorm_actions)[:, 0]
        unnorm_pred_actions = np.asarray(unnorm_pred_actions)[:, 0]
    closed = _gripper_closed(unnorm_actions)
    pred_closed = _gripper_closed(unnorm_pred_actions)
    first_grip = closed & ~np.roll(closed, 1, axis=0)

    lookback = range(1, 5)
    early_by_i = {
        i: first_grip & np.roll(pred_closed, i, axis=0) for i in lookback
    }
    out = {
        "is_first_grip": first_grip,
        "early_gripped": sum(early_by_i.values()) > 0,
        "gripped_on_time": first_grip
        & (pred_closed | np.roll(pred_closed, -1, axis=0)),
    }
    if unnorm_proprio is not None:
        z = np.asarray(unnorm_proprio)[:, 1:][:, 2]
        out["early_gripped_height_aware"] = (
            sum(
                (early_by_i[i] & (np.roll(z, i, axis=0) - z > 0.005))
                for i in lookback
            )
            > 0
        )
        height_to_grip = np.zeros_like(z)
        steps_to_grip = np.zeros_like(z)
        for i in lookback:
            pred_i = np.roll(pred_closed, i, axis=0)
            height_to_grip = np.maximum(
                height_to_grip,
                np.where(pred_i, np.roll(z, i, axis=0) - z, 0),
            )
            steps_to_grip = np.maximum(steps_to_grip, np.where(pred_i, i, 0))
        out["height_to_grip"] = np.where(first_grip, height_to_grip, 0)
        out["timestep_to_grip"] = np.where(first_grip, steps_to_grip, 0)
    return out


def _condition_info(unnorm_actions, **kwargs):
    """Boolean condition masks used for metric breakdowns: near/far from
    the episode end and whether the arm moved >=1cm."""
    n = len(unnorm_actions)
    to_end = n - np.arange(n)
    return {
        "<10_to_end": to_end < 10,
        ">20_to_end": to_end > 20,
        "moving": _moving(unnorm_actions=unnorm_actions, magnitude=0.01),
    }


def add_manipulation_metrics(info: Dict[str, Any]) -> Dict[str, Any]:
    """Adds the full manipulation metric families given a dict with keys
    actions / pred_actions / unnorm_actions / unnorm_pred_actions
    (+ optional unnorm_proprio). Scalar-quality metrics and boolean
    condition masks share the namespace, like the reference."""
    metrics = {
        **_xyz_info(**info),
        **_mse_info(**info),
        **_gripper_info(**info),
        **_gripping_early_metrics(**info),
        **_condition_info(**info),
        "xyz_close": _xyz_close(**info),
        "moving": _moving(**info),
    }
    return {**info, **metrics}


# condition masks over which metrics_for_wandb reports masked breakdowns
_CONDITION_KEYS = (
    "moving", "gripping", "releasing", "still", "<10_to_end", ">20_to_end",
    "is_first_grip",
)
_QUALITY_KEYS = (
    "gripper_correct", "xyz_angle", "xyz_angle_accuracy", "xyz_accuracy",
    "xyz_close", "mse", "mse_xyz", "mse_xyzrotation", "mse_gripper",
    "early_gripped", "gripped_on_time",
)


def masked_breakdowns(info: Dict[str, Any]) -> Dict[str, float]:
    """quality-metric means, overall and under each condition mask
    (e.g. "mse where gripping") — the reference's wandb metric table."""
    out = {}
    for qk in _QUALITY_KEYS:
        if qk not in info:
            continue
        q = np.asarray(info[qk], dtype=np.float64)
        out[qk] = float(q.mean())
        for ck in _CONDITION_KEYS:
            if ck not in info:
                continue
            mask = np.asarray(info[ck])
            # a [T] mask selects along axis 0 of [T, ...] quantities
            compatible = (
                mask.dtype == bool
                and mask.ndim <= q.ndim
                and mask.shape == q.shape[: mask.ndim]
            )
            if not compatible or not mask.any():
                continue
            out[f"{qk}_where_{ck}"] = float(q[mask].mean())
    return out


@dataclass
class Visualizer:
    """Offline metrics over a validation dataset of chunked trajectories."""

    dataset: Any
    text_processor: Optional[Any] = None
    cache_trajs: bool = True
    _cached: list = field(default_factory=list)

    def _iter_trajs(self, n):
        if self._cached and self.cache_trajs:
            yield from self._cached[:n]
            return
        for i, traj in enumerate(self.dataset):
            if i >= n:
                break
            if self.cache_trajs:
                self._cached.append(traj)
            yield traj

    def metrics_for_wandb(self, policy_fn, n_trajs: int = 8) -> Dict[str, float]:
        """Runs the policy over n trajectories and aggregates the metrics."""
        stats = None
        unnorm = getattr(self.dataset, "dataset_statistics", None)
        if isinstance(unnorm, dict) and "action" in unnorm:
            stats = unnorm["action"]

        all_metrics = []
        for traj in self._iter_trajs(n_trajs):
            out = run_policy_on_trajectory(
                policy_fn, traj, text_processor=self.text_processor
            )
            actions = np.asarray(traj["action"])[:, -1]
            pred = out["pred_actions"]
            pred = pred.reshape(actions.shape)
            if stats is not None:
                unnorm_actions = unnormalize(actions, **{
                    k: stats[k] for k in ("mean", "std") if k in stats
                }, mask=stats.get("mask"))
                unnorm_pred = unnormalize(pred, **{
                    k: stats[k] for k in ("mean", "std") if k in stats
                }, mask=stats.get("mask"))
            else:
                unnorm_actions, unnorm_pred = actions, pred
            info = add_manipulation_metrics(
                dict(
                    actions=actions,
                    pred_actions=pred,
                    unnorm_actions=unnorm_actions,
                    unnorm_pred_actions=unnorm_pred,
                )
            )
            per_traj = masked_breakdowns(info)
            per_traj["moving"] = float(np.mean(info["moving"]))
            all_metrics.append(per_traj)
        if not all_metrics:
            return {}
        keys = set().union(*(m.keys() for m in all_metrics))
        return {
            k: float(np.mean([m[k] for m in all_metrics if k in m]))
            for k in sorted(keys)
        }

    def raw_evaluations(self, policy_fn, n_trajs: int = 8):
        """Returns the per-trajectory raw info dicts (un-aggregated)."""
        infos = []
        for traj in self._iter_trajs(n_trajs):
            out = run_policy_on_trajectory(
                policy_fn, traj, text_processor=self.text_processor
            )
            infos.append(out)
        return infos

    def visualize_for_wandb(self, policy_fn, n_trajs: int = 2):
        """Returns {name: matplotlib figure} of action-vs-prediction plots."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return {}
        figures = {}
        for idx, traj in enumerate(self._iter_trajs(n_trajs)):
            out = run_policy_on_trajectory(
                policy_fn, traj, text_processor=self.text_processor
            )
            actions = np.asarray(traj["action"])[:, -1, 0]
            pred = out["pred_actions"].reshape(np.asarray(traj["action"]).shape)[
                :, -1, 0
            ]
            n_dims = actions.shape[-1]
            fig, axes = plt.subplots(
                n_dims, 1, figsize=(8, 2 * n_dims), squeeze=False
            )
            for d in range(n_dims):
                axes[d, 0].plot(actions[:, d], label="dataset")
                axes[d, 0].plot(pred[:, d], label="policy")
                axes[d, 0].set_ylabel(f"dim {d}")
            axes[0, 0].legend()
            figures[f"trajectory_{idx}"] = fig
        return figures


@dataclass
class RolloutVisualizer:
    """Closed-loop rollout metrics + optional frame capture
    (parity: octo/utils/visualization_lib.py:270-395).

    env_fn builds a gym-style environment (wrapped with the chain from
    eval/gym_wrappers.py); policy_fn maps a stacked observation dict to an
    action chunk.
    """

    env_fn: Callable
    name: str = "rollout"
    max_episode_length: int = 200

    def run_rollouts(self, policy_fn, n_rollouts: int = 10,
                     n_vis_rollouts: int = 3, record_key: str = "image_primary"):
        env = self.env_fn()
        episode_returns, episode_lengths, videos = [], [], []
        for rollout_idx in range(n_rollouts):
            obs, info = env.reset()
            done, trunc = False, False
            total_reward, length = 0.0, 0
            frames = []
            while not (done or trunc) and length < self.max_episode_length:
                if rollout_idx < n_vis_rollouts and record_key in obs:
                    frame = np.asarray(obs[record_key])
                    frames.append(frame[-1] if frame.ndim == 4 else frame)
                action = policy_fn(obs)
                obs, reward, done, trunc, info = env.step(action)
                total_reward += float(reward)
                length += 1
            episode_returns.append(total_reward)
            episode_lengths.append(length)
            if frames:
                videos.append(np.stack(frames))
        if hasattr(env, "close"):
            env.close()
        metrics = {
            f"{self.name}/mean_return": float(np.mean(episode_returns)),
            f"{self.name}/mean_length": float(np.mean(episode_lengths)),
            f"{self.name}/success_rate": float(
                np.mean([r > 0 for r in episode_returns])
            ),
        }
        return metrics, videos
