"""A pixel environment for closed-loop runs (counterpart of
hypervla_tpu/eval/pixel_env.py; numpy only).

SIMPLER and LIBERO do not run beside the policy here, so the closed loop
reset -> hypernetwork generation -> N x (render -> policy step -> env step)
is driven on this environment instead, through the same InferenceWrapper /
PolicyClient surface a simulator machine uses (tools/eval_pixel_env.py).

The task is planar reaching: a red agent square must reach the green
target square. The policy's 7-dim action is consumed like a robot
end-effector delta (action[:2] moves the agent, in pixels; the rest is
ignored), so any checkpoint with the standard action space drives it.

The environment is a `gymnasium.Env` (else a `gym.Env`) where one of the
two imports; where neither does (a GPU host without them), it is built on
`MinimalEnv` and `MinimalBox`, which carry the same reset / step / render
and the spaces' shape, dtype, low and high. `reach_env_class` builds it on
any base, so the two bases can be held to the same episodes.
"""
from typing import Optional, Tuple

import numpy as np


class MinimalBox:
    """A box space's fields: shape, dtype, low, high (arrays of the
    shape)."""

    def __init__(self, low, high, shape=None, dtype=np.float32):
        self.dtype = np.dtype(dtype)
        self.shape = tuple(shape) if shape is not None else np.shape(low)
        self.low = np.full(self.shape, low, self.dtype)
        self.high = np.full(self.shape, high, self.dtype)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return (x.shape == self.shape
                and bool(np.all(x >= self.low) & np.all(x <= self.high)))


class MinimalEnv:
    """The part of the gym Env interface the port's environments use."""

    metadata: dict = {}
    observation_space = None
    action_space = None

    def reset(self, *, seed: Optional[int] = None, options=None):
        raise NotImplementedError

    def step(self, action):
        raise NotImplementedError

    def render(self):
        raise NotImplementedError

    def close(self):
        pass


def _gym_base():
    """(Env, Box) of gymnasium, else gym, else the minimal local base."""
    try:
        import gymnasium as gym
        from gymnasium import spaces
    except ImportError:
        try:
            import gym
            from gym import spaces
        except ImportError:
            return MinimalEnv, MinimalBox
    return gym.Env, spaces.Box


class _PixelReach:
    """64x64 RGB reach task. Observation: pixels. Action: (7,) float,
    action[:2] = xy velocity in [-1, 1] (scaled to max_speed px/step)."""

    metadata = {"render_modes": ["rgb_array"]}

    def __init__(self, size: int = 64, max_steps: int = 40,
                 max_speed: float = 6.0, success_radius: float = 5.0,
                 seed: Optional[int] = None):
        self.size = size
        self.max_steps = max_steps
        self.max_speed = max_speed
        self.success_radius = success_radius
        self.observation_space = self._box(0, 255, (size, size, 3),
                                           dtype=np.uint8)
        self.action_space = self._box(-np.inf, np.inf, (7,), np.float32)
        self._rng = np.random.RandomState(seed)
        self._agent = np.zeros(2)
        self._goal = np.zeros(2)
        self._t = 0

    def reset(self, *, seed: Optional[int] = None, options=None
              ) -> Tuple[np.ndarray, dict]:
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        margin = 8
        self._agent = self._rng.uniform(margin, self.size - margin, 2)
        while True:
            self._goal = self._rng.uniform(margin, self.size - margin, 2)
            if np.linalg.norm(self._goal - self._agent) > self.size / 3:
                break
        self._t = 0
        return self._render(), {"task": self.get_task_description()}

    def step(self, action):
        v = np.clip(np.asarray(action, np.float64)[:2], -1.0, 1.0)
        self._agent = np.clip(self._agent + v * self.max_speed, 4,
                              self.size - 4)
        self._t += 1
        dist = float(np.linalg.norm(self._goal - self._agent))
        success = dist <= self.success_radius
        terminated = success
        truncated = self._t >= self.max_steps
        reward = 1.0 if success else -dist / self.size
        return (self._render(), reward, terminated, truncated,
                {"success": success, "dist": dist})

    def get_task_description(self) -> str:
        return "move the red square to the green target"

    def _render(self) -> np.ndarray:
        img = np.full((self.size, self.size, 3), 32, np.uint8)
        self._blit(img, self._goal, (40, 200, 40))
        self._blit(img, self._agent, (220, 50, 50))
        return img

    def _blit(self, img, center, color, half: int = 3):
        x0, y0 = (int(c) for c in center)
        xs = slice(max(x0 - half, 0), min(x0 + half + 1, self.size))
        ys = slice(max(y0 - half, 0), min(y0 + half + 1, self.size))
        img[ys, xs] = color

    def render(self):
        return self._render()


def reach_env_class(env_base, box):
    """PixelReachEnv's class on the base `env_base` with spaces of type
    `box`."""
    return type("PixelReachEnv", (_PixelReach, env_base),
                {"_box": box, "__module__": __name__,
                 "__doc__": _PixelReach.__doc__})


PixelReachEnv = reach_env_class(*_gym_base())


def scripted_expert(obs_agent: np.ndarray, obs_goal: np.ndarray
                    ) -> np.ndarray:
    """Oracle action toward the goal (for data generation / sanity)."""
    delta = obs_goal - obs_agent
    n = np.linalg.norm(delta)
    v = delta / n if n > 1e-6 else delta
    action = np.zeros(7, np.float32)
    action[:2] = v
    return action
