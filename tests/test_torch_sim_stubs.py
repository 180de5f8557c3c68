"""Stand-ins for the simulators the evaluators drive, with their
interfaces (the modules `simpler_env` and `libero`, as
tests/test_sim_evaluators.py builds them), an InferenceWrapper-shaped
policy, and a counting environment that a spawned vector-env worker can
import. The port's CPU tests install them with pytest's monkeypatch;
chip_smoke.py installs them for its eval phase with `installed`, so this
file imports nothing of either package (numpy, and the harness's fixture,
which imports torch and pytest).

The tests below hold the stand-ins to what the evaluators read."""
import contextlib
import sys
import types

import numpy as np

from test_torch_harness import torch_threads  # noqa: F401


def _zeros_frame(env, obs):
    return np.zeros((64, 64, 3), np.uint8)


class MockPolicy:
    """InferenceWrapper-shaped: a zero action every step; counts resets."""

    def __init__(self):
        self.resets = 0

    def reset(self, instruction, instruction_dict=None, **kwargs):
        self.resets += 1

    def step(self, image):
        # raw, action, image, attention map, model seconds
        return None, np.zeros(7), image, None, 0.001


class AttentionPolicy(MockPolicy):
    """MockPolicy with a (4, 17, 17) attention map every step."""

    def step(self, image):
        return None, np.zeros(7), image, np.ones((4, 17, 17)), 0.001


def install_mock_simpler(setitem, episode_success, frame_fn=_zeros_frame,
                         max_episode_steps=4):
    """Installs a `simpler_env` whose environments end an episode with
    success from its second step where episode_success(episode) holds,
    and whose get_image_from_maniskill2_obs_dict is frame_fn(env, obs).
    setitem(name, module) puts a module into sys.modules. Returns {task
    name: its environment}."""

    class _Spec:
        pass

    _Spec.max_episode_steps = max_episode_steps

    class MockEnv:
        def __init__(self, task_name):
            self.task_name = task_name
            self.spec = _Spec()
            self.episode = -1
            self.t = 0
            self.seen_options = []
            self.seeds = []

        def reset(self, seed=0, options=None):
            self.episode += 1
            self.t = 0
            self.seen_options.append(options)
            self.seeds.append(seed)
            return {"obs": 0}, {}

        def get_language_instruction(self):
            return f"do {self.task_name}"

        def step(self, action):
            self.t += 1
            done = episode_success(self.episode) and self.t >= 2
            return {"obs": self.t}, 0.0, done, False, {}

        def close(self):
            pass

    envs = {}
    simpler_env = types.ModuleType("simpler_env")
    simpler_env.make = lambda name: envs.setdefault(name, MockEnv(name))
    utils = types.ModuleType("simpler_env.utils")
    env_mod = types.ModuleType("simpler_env.utils.env")
    obs_utils = types.ModuleType("simpler_env.utils.env.observation_utils")
    obs_utils.get_image_from_maniskill2_obs_dict = frame_fn
    setitem("simpler_env", simpler_env)
    setitem("simpler_env.utils", utils)
    setitem("simpler_env.utils.env", env_mod)
    setitem("simpler_env.utils.env.observation_utils", obs_utils)
    return envs


def mock_suite(names):
    """A LIBERO task suite of the named tasks, three init states each."""

    class MockTask:
        def __init__(self, name):
            self.name = name
            self.language = f"do {name}"
            self.problem_folder = "f"
            self.bddl_file = f"{name}.bddl"

    class MockSuite:
        n_tasks = len(names)

        def get_task(self, i):
            return MockTask(names[i])

        def get_task_init_states(self, i):
            return np.zeros((3, 5))

    return MockSuite


def install_mock_libero(setitem, suites, done_after=3, frame=None):
    """Installs a `libero` whose benchmark dict is `suites` ({name: suite
    class}) and whose OffScreenRenderEnv ends every episode with success
    at step `done_after`, rendering `frame` (default zeros (64, 64, 3)).
    Returns the list the environments go to."""
    frame = np.zeros((64, 64, 3), np.uint8) if frame is None else frame
    made = []

    class MockEnv:
        def __init__(self, **kwargs):
            self.kwargs = kwargs
            self.t = 0
            self.seeds = []
            made.append(self)

        def reset(self):
            self.t = 0

        def seed(self, s):
            self.seeds.append(s)

        def set_init_state(self, s):
            return {"agentview_image": frame}

        def step(self, action):
            self.t += 1
            return {"agentview_image": frame}, 0.0, self.t >= done_after, {}

        def close(self):
            pass

    libero_pkg = types.ModuleType("libero")
    libero_sub = types.ModuleType("libero.libero")
    libero_sub.benchmark = types.SimpleNamespace(
        get_benchmark_dict=lambda: dict(suites))
    libero_sub.get_libero_path = lambda name: "/nonexistent"
    libero_envs = types.ModuleType("libero.libero.envs")
    libero_envs.OffScreenRenderEnv = MockEnv
    setitem("libero", libero_pkg)
    setitem("libero.libero", libero_sub)
    setitem("libero.libero.envs", libero_envs)
    return made


@contextlib.contextmanager
def installed(install, *args, **kwargs):
    """Runs install(setitem, *args, **kwargs) with a setitem into
    sys.modules and yields its result; the modules it replaced come back
    after."""
    saved = {}

    def setitem(name, module):
        saved.setdefault(name, sys.modules.get(name))
        sys.modules[name] = module

    try:
        yield install(setitem, *args, **kwargs)
    finally:
        for name, module in saved.items():
            if module is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = module


class CountingEnv:
    """Observation counts steps (offset by `offset`); done after 3 steps;
    reward is the action."""

    def __init__(self, offset=0):
        self.offset = offset
        self.t = 0

    def reset(self, **kwargs):
        self.t = 0
        return self._obs(), {}

    def step(self, action):
        self.t += 1
        return self._obs(), float(action), self.t >= 3, False, {"t": self.t}

    def _obs(self):
        return {
            "image": np.full((4, 4, 3), self.t + self.offset, dtype=np.uint8),
            "state": np.array([self.t], dtype=np.float32),
        }

    def close(self):
        pass


def test_installed_puts_back_what_was_there():
    before = sys.modules.get("simpler_env")
    with installed(install_mock_simpler, lambda ep: True) as envs:
        import simpler_env

        env = simpler_env.make("task")
        assert envs == {"task": env} and env.spec.max_episode_steps == 4
    assert sys.modules.get("simpler_env") is before


def test_the_stand_ins_end_episodes_as_the_evaluators_read_them():
    with installed(install_mock_simpler, lambda ep: ep == 0,
                   max_episode_steps=7) as envs:
        import simpler_env

        env = simpler_env.make("t")
        env.reset(seed=3, options={"a": 1})
        dones = [env.step(None)[2] for _ in range(3)]
        assert dones == [False, True, True] and env.seeds == [3]
        env.reset()
        assert not any(env.step(None)[2] for _ in range(3))
    with installed(install_mock_libero, {"s": mock_suite(["a", "b"])},
                   done_after=2) as made:
        from libero.libero import benchmark
        from libero.libero.envs import OffScreenRenderEnv

        suite = benchmark.get_benchmark_dict()["s"]()
        assert suite.n_tasks == 2 and suite.get_task(1).name == "b"
        env = OffScreenRenderEnv(bddl_file_name="x")
        assert made == [env]
        assert [env.step(None)[2] for _ in range(2)] == [False, True]
