"""The port's environments and their plumbing against the JAX package's,
on the CPU: PixelReachEnv (hypervla_tpu_torch/eval/pixel_env.py, on
gymnasium and on its minimal local base), every case of
tests/test_gym_wrappers.py on both packages' wrappers (eval/
gym_wrappers.py), ProprioNorm, and the vector envs (eval/venv.py).

ResizeImage resizes through each package's own preprocessing, which round
to uint8 where a value at .5 may round either way: its pixels are held to
tests/test_torch_preprocess.py's bound and the JAX package's pixels are fed
on through the rest of the chain, as tests/test_torch_host_path.py::
step_both does for the wrapper's resize. Everything else is equal."""
import copy
from collections import deque

import gymnasium as gym
import numpy as np
import pytest

from hypervla_tpu.eval import gym_wrappers as jwrappers
from hypervla_tpu.eval import venv as jvenv
from hypervla_tpu.eval.pixel_env import PixelReachEnv as JaxPixelReachEnv
from hypervla_tpu.eval.pixel_env import scripted_expert as jax_expert
from hypervla_tpu_torch.eval import gym_wrappers as wrappers
from hypervla_tpu_torch.eval import pixel_env, venv
from test_torch_harness import torch_threads, within  # noqa: F401
from test_torch_preprocess import _assert_close_u8
from test_torch_sim_stubs import CountingEnv as VenvCountingEnv

PACKAGES = {"jax": jwrappers, "port": wrappers}


def _episodes(env, expert, episodes=3, seed0=0):
    """Every observation, reward, flag and info of `episodes` seeded
    episodes: the expert's action with a seeded perturbation, away from
    the goal in the last episode (which hits the step cap)."""
    rng = np.random.default_rng(seed0)
    out = []
    for ep in range(episodes):
        obs, info = env.reset(seed=seed0 + ep)
        out.append(("reset", obs, info))
        sign = -1.0 if ep == episodes - 1 else 1.0
        while True:
            action = sign * expert(env._agent, env._goal) + rng.normal(
                0, 0.5, 7).astype(np.float32)
            obs, reward, terminated, truncated, info = env.step(action)
            out.append(("step", obs, reward, terminated, truncated, info))
            if terminated or truncated:
                break
    return out


def _assert_same(a, b):
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b)), (
        type(a), type(b))
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_pixel_reach_env_matches_jax():
    ref = _episodes(JaxPixelReachEnv(seed=0, max_steps=40), jax_expert)
    got = _episodes(pixel_env.PixelReachEnv(seed=0, max_steps=40),
                    pixel_env.scripted_expert)
    _assert_same(got, ref)
    flags = [e[3] for e in got if e[0] == "step"]
    truncs = [e[4] for e in got if e[0] == "step"]
    assert any(flags) and any(truncs)  # successes and capped episodes
    env = pixel_env.PixelReachEnv()
    assert isinstance(env, gym.Env)
    assert env.observation_space.shape == (64, 64, 3)
    assert env.observation_space.dtype == np.uint8
    np.testing.assert_array_equal(env.render(), env._render())


def test_the_minimal_base_runs_the_same_episodes():
    """The base a host without gymnasium and gym takes: the same episodes,
    the same spaces' shape, dtype and bounds."""
    local = pixel_env.reach_env_class(pixel_env.MinimalEnv,
                                      pixel_env.MinimalBox)
    a, b = local(seed=0), pixel_env.PixelReachEnv(seed=0)
    assert not isinstance(a, gym.Env)
    _assert_same(_episodes(a, pixel_env.scripted_expert),
                 _episodes(b, pixel_env.scripted_expert))
    for name in ("observation_space", "action_space"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.shape == y.shape and x.dtype == y.dtype
        np.testing.assert_array_equal(x.low, y.low)
        np.testing.assert_array_equal(x.high, y.high)
    assert a.observation_space.contains(a.render())
    assert not a.observation_space.contains(np.zeros((3, 3), np.uint8))


class CountingEnv(gym.Env):
    """tests/test_gym_wrappers.py's environment: observation = step
    counter; reward = the action's first element. noise=True gives random
    frames (a seeded generator) for the resize."""

    def __init__(self, image_size=32, noise=False, proprio=False):
        spaces = {
            "image_primary": gym.spaces.Box(
                0, 255, (image_size, image_size, 3), np.uint8),
            "step": gym.spaces.Box(-np.inf, np.inf, (1,), np.float32),
        }
        if proprio:
            spaces["proprio"] = gym.spaces.Box(-np.inf, np.inf, (3,),
                                               np.float32)
        self.observation_space = gym.spaces.Dict(spaces)
        self.action_space = gym.spaces.Box(-1, 1, (7,), np.float32)
        self.image_size = image_size
        self.noise = noise
        self.proprio = proprio
        self.t = 0
        self.rng = np.random.default_rng(0)

    def _obs(self):
        shape = (self.image_size, self.image_size, 3)
        image = (self.rng.integers(0, 256, shape, dtype=np.uint8)
                 if self.noise else np.full(shape, self.t % 255, np.uint8))
        obs = {"image_primary": image,
               "step": np.array([self.t], np.float32)}
        if self.proprio:
            obs["proprio"] = np.array([self.t, 2.0 * self.t, -1.0],
                                      np.float32)
        return obs

    def reset(self, **kwargs):
        self.t = 0
        return self._obs(), {}

    def step(self, action):
        self.t += 1
        return (self._obs(), float(np.asarray(action).ravel()[0]),
                self.t >= 20, False, {})


def _both(build, steps, **env_kwargs):
    """[reset, step(a) for a in steps] through build(module, env) for each
    package, each on its own CountingEnv(**env_kwargs)."""
    out = {}
    for name, module in PACKAGES.items():
        env = build(module, CountingEnv(**env_kwargs))
        results = [env.reset()]
        results += [env.step(a) for a in steps]
        out[name] = results
    return out


def test_history_wrapper_matches_jax():
    out = _both(lambda m, e: m.HistoryWrapper(e, horizon=3),
                [np.zeros(7)] * 4)
    _assert_same(out["port"], out["jax"])
    obs = out["port"]
    np.testing.assert_array_equal(obs[0][0]["timestep_pad_mask"], [0, 0, 1])
    np.testing.assert_array_equal(obs[1][0]["timestep_pad_mask"], [0, 1, 1])
    np.testing.assert_array_equal(obs[3][0]["step"][:, 0], [1, 2, 3])
    for name, module in PACKAGES.items():
        space = module.HistoryWrapper(CountingEnv(), horizon=3
                                      ).observation_space
        assert space["image_primary"].shape == (3, 32, 32, 3), name


def test_rhc_wrapper_matches_jax():
    chunk = np.arange(4 * 7, dtype=np.float32).reshape(4, 7)
    out = _both(lambda m, e: m.RHCWrapper(e, exec_horizon=3), [chunk])
    _assert_same(out["port"], out["jax"])
    obs, reward, done, trunc, infos = out["port"][1]
    assert reward == 0 + 7 + 14 and len(infos["rewards"]) == 3
    assert obs["step"][0] == 3
    one = _both(lambda m, e: m.RHCWrapper(e, exec_horizon=1),
                [np.full(7, 0.5, np.float32)])
    _assert_same(one["port"], one["jax"])


def test_temporal_ensemble_wrapper_matches_jax():
    steps = [np.ones((2, 7), np.float32), 3 * np.ones((2, 7), np.float32),
             np.arange(14, dtype=np.float32).reshape(2, 7)]
    for weight in (0, 1):
        out = _both(lambda m, e: m.TemporalEnsembleWrapper(
            e, pred_horizon=2, exp_weight=weight), steps)
        _assert_same(out["port"], out["jax"])
    # weights exp(-age) in history order: the oldest chunk weighs 1
    assert [r[1] for r in out["port"][1:3]] == [
        1.0, float((1 + 3 * np.exp(-1)) / (1 + np.exp(-1)))]
    out = _both(lambda m, e: m.TemporalEnsembleWrapper(e, pred_horizon=2),
                steps[:2])
    assert [r[1] for r in out["port"][1:]] == [1.0, 2.0]


def _resize_fed_on(port_env, jax_env):
    """Patches the port chain's ResizeImage wrapper to hold its pixels to
    the bound against the JAX chain's and hand on the JAX pixels."""
    def find(env, module):
        cls = module._registry()["ResizeImage"]
        while not isinstance(env, cls):
            env = env.env
        return env

    port_resize, jax_resize = find(port_env, wrappers), find(jax_env,
                                                             jwrappers)
    own = port_resize.observation

    def observation(obs):
        ref = jax_resize.observation(copy.deepcopy(obs))
        got = own(obs)
        for k in port_resize.keys_to_resize:
            assert got[k].shape == ref[k].shape and got[k].dtype == np.uint8
            _assert_close_u8(got[k], ref[k])
            got[k] = ref[k]
        return got

    port_resize.observation = observation
    return port_resize


@pytest.mark.parametrize("augmented", [("image_primary",), ()])
def test_resize_wrapper_matches_jax(augmented):
    envs = {name: module.ResizeImageWrapper(
        CountingEnv(image_size=64, noise=True), {"primary": (32, 32)},
        augmented_keys=augmented, avg_scale=0.8, avg_ratio=1.2)
        for name, module in PACKAGES.items()}
    assert (envs["port"].bounding_box == envs["jax"].bounding_box)
    assert envs["port"].observation_space["image_primary"].shape == (32, 32,
                                                                     3)
    for _ in range(3):
        obs = envs["jax"].env.step(np.zeros(7))[0]
        ref = envs["jax"].observation(copy.deepcopy(obs))
        got = envs["port"].observation(copy.deepcopy(obs))
        _assert_close_u8(got["image_primary"], ref["image_primary"])
        np.testing.assert_array_equal(got["step"], ref["step"])


def test_full_chain_matches_jax():
    """add_octo_env_wrappers: proprio norm -> resize -> history ->
    temporal ensemble (and the receding-horizon variant)."""
    meta = {"proprio": {"mean": [1.0, 2.0, 0.0], "std": [2.0, 4.0, 1.0],
                        "mask": [True, True, False]}}
    for temp in (True, False):
        envs = {name: module.add_octo_env_wrappers(
            CountingEnv(image_size=64, noise=True, proprio=True),
            action_proprio_metadata=copy.deepcopy(meta), horizon=2,
            exec_horizon=2, resize_size={"primary": (32, 32)},
            use_temp_ensembling=temp)
            for name, module in PACKAGES.items()}
        _resize_fed_on(envs["port"], envs["jax"])
        chunks = [np.full((2, 7), i / 4, np.float32) for i in range(3)]
        got = [envs["port"].reset()] + [envs["port"].step(c) for c in chunks]
        ref = [envs["jax"].reset()] + [envs["jax"].step(c) for c in chunks]
        _assert_same(got, ref)
        obs = got[1][0]
        assert obs["image_primary"].shape == (2, 32, 32, 3)
        assert obs["image_primary"].dtype == np.uint8
        assert obs["timestep_pad_mask"].shape == (2,)


def test_proprio_norm_matches_jax():
    meta = {"proprio": {"mean": [1.0, 2.0, 0.0], "std": [2.0, 4.0, 1.0],
                        "mask": [True, False, True]},
            "action": {"mean": np.zeros(7), "std": 1.0}}
    out = _both(lambda m, e: m.NormalizeProprio(e, copy.deepcopy(meta)),
                [np.zeros(7)] * 2, proprio=True)
    _assert_same(out["port"], out["jax"])
    p = out["port"][2][0]["proprio"]
    np.testing.assert_allclose(p, [(2 - 1) / (2 + 1e-8), 4.0,
                                   -1 / (1 + 1e-8)], rtol=1e-6)
    jmeta = jwrappers.NormalizeProprio(CountingEnv(), copy.deepcopy(meta)
                                       ).action_proprio_metadata
    pmeta = wrappers.NormalizeProprio(CountingEnv(), copy.deepcopy(meta)
                                      ).action_proprio_metadata
    _assert_same(pmeta, jmeta)
    for name, module in PACKAGES.items():  # no metadata for a proprio obs
        env = module.NormalizeProprio(CountingEnv(proprio=True), {})
        with pytest.raises(AssertionError, match="proprio"):
            env.reset()


def test_stack_and_pad_and_space_stack_match_jax():
    hist = deque([{"a": np.array([i])} for i in range(4)], maxlen=4)
    _assert_same(wrappers.stack_and_pad(hist, 2),
                 jwrappers.stack_and_pad(hist, 2))
    space = gym.spaces.Dict({"x": gym.spaces.Box(0, 1, (2,), np.float32),
                             "d": gym.spaces.Discrete(5)})
    got, ref = wrappers.space_stack(space, 3), jwrappers.space_stack(space,
                                                                     3)
    assert got == ref
    for module in PACKAGES.values():
        with pytest.raises(ValueError, match="not supported"):
            module.space_stack(gym.spaces.MultiBinary(2), 2)
    assert wrappers.listdict2dictlist([{"a": 1}, {"a": 2}]) == {"a": [1, 2]}


def test_dummy_vector_env_matches_jax():
    out = {}
    for name, module in (("jax", jvenv), ("port", venv)):
        vec = module.DummyVectorEnv(
            [lambda i=i: VenvCountingEnv(i) for i in range(3)])
        results = [vec.reset(), vec.step([1.0, 2.0, 3.0])]
        results += [vec.step([0.0] * 3) for _ in range(2)]
        results.append(vec.getattr("offset"))
        vec.close()
        out[name] = results
    _assert_same(out["port"], out["jax"])
    assert all(out["port"][-2][2]) and out["port"][-1] == [0, 1, 2]


def test_sharray_roundtrip():
    sh = venv.ShArray(np.uint8, (2, 3))
    sh.save(np.arange(6, dtype=np.uint8).reshape(2, 3))
    np.testing.assert_array_equal(sh.get(),
                                  np.arange(6, dtype=np.uint8).reshape(2, 3))


def test_subproc_vector_env_matches_the_dummy_one():
    """Two spawned workers with shared-memory observations: the same
    transitions as the in-process vector env, the workers gone after
    close."""
    fns = [lambda i=i: VenvCountingEnv(i) for i in range(2)]

    def run(vec):
        results = [vec.reset(), vec.step([5.0, 6.0]), vec.step([0.0, 1.0]),
                   vec.getattr("offset")]
        vec.close()
        return results

    sample = VenvCountingEnv().reset()[0]
    sub = within(120, venv.SubprocVectorEnv, fns, obs_sample=sample)
    got = within(120, run, sub)
    _assert_same(got, run(venv.DummyVectorEnv(fns)))
    assert not any(p.is_alive() for p in sub.processes)
    np.testing.assert_array_equal(got[0][0][1]["image"][0, 0], [1, 1, 1])
