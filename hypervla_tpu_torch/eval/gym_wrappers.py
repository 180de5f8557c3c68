"""Gym environment wrappers (counterpart of hypervla_tpu/eval/
gym_wrappers.py): history stacking with pad masks, receding-horizon
control, ACT-style temporal ensembling, the image resize of the training
pipeline (lanczos3, then the average crop-and-resize of the train-time
augmentation, through ops/preprocess.py on the CPU), and proprio
normalization.

`gym` (or gymnasium: both share the 5-tuple step API used here) is imported
lazily and the wrapper classes are built once against whichever is
installed, so a host without either imports this module. The public names
are factories returning instances of those cached classes.
"""
import logging
from collections import deque
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

_REGISTRY = None


def _gym():
    try:
        import gym
    except ImportError:
        import gymnasium as gym

    return gym


def stack_and_pad(history: deque, num_obs: int):
    """Stacks a history window into batched arrays and marks the leading
    repeated-reset frames as padding."""
    horizon = len(history)
    stacked = {
        key: np.stack([frame[key] for frame in history])
        for key in history[0]
    }
    valid = min(num_obs, horizon)
    mask = np.ones(horizon)
    mask[: horizon - valid] = 0
    stacked["timestep_pad_mask"] = mask
    return stacked


def space_stack(space, repeat: int):
    """Repeats a gym space along a new leading axis."""
    spaces = _gym().spaces
    rep = lambda bound: np.repeat(bound[None], repeat, axis=0)  # noqa: E731
    builders = {
        spaces.Box: lambda s: spaces.Box(
            low=rep(s.low), high=rep(s.high), dtype=s.dtype
        ),
        spaces.Discrete: lambda s: spaces.MultiDiscrete([s.n] * repeat),
        spaces.Dict: lambda s: spaces.Dict(
            {k: space_stack(v, repeat) for k, v in s.spaces.items()}
        ),
    }
    for kind, build in builders.items():
        if isinstance(space, kind):
            return build(space)
    raise ValueError(f"Space {space} is not supported.")


def listdict2dictlist(LD):
    return {k: [dic[k] for dic in LD] for k in LD[0]}


def _ensemble_chunks(act_history, exp_weight: float) -> np.ndarray:
    """ACT temporal ensembling: the j-th most recent chunk contributes its
    (n-1-j)-th action (they all target the same control step), weighted
    exp(-w * age) and normalized."""
    n = len(act_history)
    chunks = np.stack(list(act_history))  # (n, pred_horizon, adim)
    aligned = chunks[np.arange(n), n - 1 - np.arange(n)]
    w = np.exp(-exp_weight * np.arange(n))
    return np.einsum("i,i...->...", w / w.sum(), aligned)


def _arrays(tree):
    """The metadata with every leaf, and every list, as a numpy array;
    dicts and tuples are walked, None stays None (what the JAX package's
    tree_map(np.array, tree, is_leaf=list) makes of it)."""
    if isinstance(tree, dict):
        return {k: _arrays(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return np.array(tree)
    if isinstance(tree, tuple):
        return tuple(_arrays(v) for v in tree)
    if tree is None:
        return None
    return np.array(tree)


def _build_registry():
    """Defines the wrapper classes once against the installed gym."""
    gym = _gym()

    class History(gym.Wrapper):
        """Accumulates `horizon` observations with a timestep_pad_mask."""

        def __init__(self, env, horizon: int):
            super().__init__(env)
            self.horizon = horizon
            self.history = deque(maxlen=horizon)
            self.num_obs = 0
            self.observation_space = space_stack(
                self.env.observation_space, horizon
            )

        def step(self, action):
            frame, *rest = self.env.step(action)
            self.num_obs += 1
            self.history.append(frame)
            assert len(self.history) == self.horizon
            return (stack_and_pad(self.history, self.num_obs), *rest)

        def reset(self, **kwargs):
            frame, reset_info = self.env.reset(**kwargs)
            self.num_obs = 1
            self.history.extend([frame] * self.horizon)
            return stack_and_pad(self.history, self.num_obs), reset_info

    class RHC(gym.Wrapper):
        """Receding-horizon control: executes the first exec_horizon
        actions of each predicted chunk."""

        def __init__(self, env, exec_horizon: int):
            super().__init__(env)
            self.exec_horizon = exec_horizon

        def step(self, actions):
            if self.exec_horizon == 1 and actions.ndim == 1:
                actions = actions[None]
            assert len(actions) >= self.exec_horizon
            transitions = []
            for act in actions[: self.exec_horizon]:
                transitions.append(self.env.step(act))
                terminated, truncated = transitions[-1][2:4]
                if terminated or truncated:
                    break
            frame = transitions[-1][0]
            rewards = [t[1] for t in transitions]
            merged = listdict2dictlist([t[4] for t in transitions])
            merged["rewards"] = rewards
            merged["observations"] = [t[0] for t in transitions]
            return frame, np.sum(rewards), terminated, truncated, merged

    class TemporalEnsemble(gym.Wrapper):
        """Temporal ensembling (ACT-style) over overlapping chunks."""

        def __init__(self, env, pred_horizon: int, exp_weight: int = 0):
            super().__init__(env)
            self.pred_horizon = pred_horizon
            self.exp_weight = exp_weight
            self.act_history = deque(maxlen=pred_horizon)
            self.action_space = space_stack(
                self.env.action_space, pred_horizon
            )

        def step(self, actions):
            assert len(actions) >= self.pred_horizon
            self.act_history.append(actions[: self.pred_horizon])
            action = _ensemble_chunks(self.act_history, self.exp_weight)
            return self.env.step(action)

        def reset(self, **kwargs):
            self.act_history.clear()
            return self.env.reset(**kwargs)

    class ResizeImage(gym.ObservationWrapper):
        """lanczos3 resize + the average crop-and-resize of the training
        augmentation on the augmented keys."""

        def __init__(self, env, resize_size, augmented_keys, avg_scale,
                     avg_ratio):
            super().__init__(env)
            assert isinstance(self.observation_space, gym.spaces.Dict)
            self.augmented_keys = augmented_keys
            # center box of the mean random_resized_crop draw
            h = float(np.clip(np.sqrt(avg_scale / avg_ratio), 0, 1))
            w = float(np.clip(np.sqrt(avg_scale * avg_ratio), 0, 1))
            self.bounding_box = (
                (1 - h) / 2, (1 - w) / 2, (1 + h) / 2, (1 + w) / 2
            )
            self.keys_to_resize = (
                {} if resize_size is None
                else {f"image_{i}": resize_size[i] for i in resize_size}
            )
            logging.info(f"Resizing images: {self.keys_to_resize}")
            spaces = self.observation_space.spaces
            for k, size in self.keys_to_resize.items():
                spaces[k] = gym.spaces.Box(
                    low=0, high=255, shape=size + (3,), dtype=np.uint8
                )
            self.observation_space = gym.spaces.Dict(spaces)

        def observation(self, observation):
            import torch

            from hypervla_tpu_torch.ops import preprocess

            for k, size in self.keys_to_resize.items():
                image = preprocess.resize_image(
                    torch.as_tensor(np.asarray(observation[k])), size)
                if k in self.augmented_keys:
                    image = preprocess.crop_and_resize_bilinear(
                        image.float(), self.bounding_box, size)
                    image = torch.clamp(torch.round(image), 0, 255).to(
                        torch.uint8)
                observation[k] = image.numpy()
            return observation

    class ProprioNorm(gym.ObservationWrapper):
        """Normalizes proprio observations with dataset statistics."""

        def __init__(self, env, action_proprio_metadata):
            self.action_proprio_metadata = _arrays(action_proprio_metadata)
            super().__init__(env)

        @staticmethod
        def normalize(data, metadata):
            mask = metadata.get(
                "mask", np.ones_like(metadata["mean"], dtype=bool)
            )
            z = (data - metadata["mean"]) / (metadata["std"] + 1e-8)
            return np.where(mask, z, data)

        def observation(self, obs):
            stats = self.action_proprio_metadata
            if "proprio" in stats:
                obs["proprio"] = self.normalize(
                    obs["proprio"], stats["proprio"]
                )
            else:
                assert "proprio" not in obs, (
                    "Cannot normalize proprio without metadata."
                )
            return obs

    return dict(
        History=History, RHC=RHC, TemporalEnsemble=TemporalEnsemble,
        ResizeImage=ResizeImage, ProprioNorm=ProprioNorm,
    )


def _registry():
    global _REGISTRY
    if _REGISTRY is None:
        _REGISTRY = _build_registry()
    return _REGISTRY


# ---- public factories (same call signatures as the octo wrappers) ----

def HistoryWrapper(env, horizon: int):
    return _registry()["History"](env, horizon)


def RHCWrapper(env, exec_horizon: int):
    return _registry()["RHC"](env, exec_horizon)


def TemporalEnsembleWrapper(env, pred_horizon: int, exp_weight: int = 0):
    return _registry()["TemporalEnsemble"](env, pred_horizon, exp_weight)


def ResizeImageWrapper(
    env,
    resize_size: Optional[Dict[str, Tuple]] = None,
    augmented_keys: Sequence[str] = ("image_primary",),
    avg_scale: float = 0.9,
    avg_ratio: float = 1.0,
):
    return _registry()["ResizeImage"](
        env, resize_size, augmented_keys, avg_scale, avg_ratio
    )


def NormalizeProprio(env, action_proprio_metadata: dict):
    return _registry()["ProprioNorm"](env, action_proprio_metadata)


def add_octo_env_wrappers(
    env,
    action_proprio_metadata: dict,
    horizon: int,
    exec_horizon: int,
    resize_size: Optional[Dict[str, Tuple]] = None,
    use_temp_ensembling: bool = True,
):
    """Stacks the standard chain: proprio norm -> resize -> history ->
    temporal ensemble / receding horizon."""
    env = NormalizeProprio(env, action_proprio_metadata)
    env = ResizeImageWrapper(env, resize_size)
    env = HistoryWrapper(env, horizon)
    chunking = TemporalEnsembleWrapper if use_temp_ensembling else RHCWrapper
    return chunking(env, exec_horizon)
