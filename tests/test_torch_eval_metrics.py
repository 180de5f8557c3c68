"""The port's numpy eval modules against the JAX package's, on the CPU:
the rotation conversions (eval/action_space.py), BatchActionEnsembler
(eval/action_ensemble.py), and eval/visualization.py: the manipulation
metrics, their masked breakdowns, Visualizer.metrics_for_wandb over the
same trajectories and policy, RolloutVisualizer's closed-loop rollouts
on PixelReachEnv under the scripted expert, and the trainer's
RolloutCallback over them. The code is numpy in both packages: every
result is bit-equal."""
import numpy as np
import pytest

from hypervla_tpu.eval import action_ensemble as jensemble
from hypervla_tpu.eval import action_space as jspace
from hypervla_tpu.eval import pixel_env as jpixel
from hypervla_tpu.eval import visualization as jviz
from hypervla_tpu.data.text_processing import FallbackTokenizer as JaxTok
from hypervla_tpu.train.callbacks import RolloutCallback as JaxCallback
from hypervla_tpu_torch.data.text_processing import FallbackTokenizer
from hypervla_tpu_torch.eval import action_ensemble, action_space, pixel_env
from hypervla_tpu_torch.eval import visualization as viz
from hypervla_tpu_torch.train.callbacks import RolloutCallback
from test_torch_eval_envs import _assert_same
from test_torch_harness import torch_threads  # noqa: F401


def _angles(n, seed=0):
    rng = np.random.default_rng(seed)
    out = list(rng.uniform(-np.pi, np.pi, (n, 3)))
    # gimbal lock, the identity and angles near pi
    out += [np.array([0.3, np.pi / 2, 0.1]), np.array([0.2, -np.pi / 2, 0.5]),
            np.zeros(3), np.array([np.pi, 0.0, 0.0]),
            np.array([0.0, np.pi - 1e-7, 0.0])]
    return out


def test_rotation_conversions_match_jax():
    for rpy in _angles(200):
        ax, angle = action_space.euler2axangle(*rpy)
        jax_ax, jax_angle = jspace.euler2axangle(*rpy)
        np.testing.assert_array_equal(ax, jax_ax)
        assert angle == jax_angle
        got = action_space.axangle2euler(ax, angle)
        assert got == jspace.axangle2euler(jax_ax, jax_angle)
        for dtype in (np.float32, np.float64):
            vec = (np.asarray(ax) * angle).astype(dtype)
            rpy_back = action_space.convert_axangle_to_rpy(vec)
            np.testing.assert_array_equal(
                rpy_back, jspace.convert_axangle_to_rpy(vec))
            assert rpy_back.dtype == dtype
        np.testing.assert_array_equal(
            action_space._axangle_to_mat(np.asarray(ax), angle),
            jspace._axangle_to_mat(np.asarray(ax), angle))
        np.testing.assert_array_equal(
            action_space._mat_to_euler(action_space._euler_to_mat(*rpy)),
            jspace._mat_to_euler(jspace._euler_to_mat(*rpy)))


def test_rotation_round_trips():
    """rpy -> axis-angle -> rpy returns the same rotation (the angles up to
    the sxyz convention's two solutions), and a small scaled axis-angle
    vector goes through rpy and back."""
    for rpy in _angles(100, seed=1):
        back = action_space.axangle2euler(*action_space.euler2axangle(*rpy))
        np.testing.assert_allclose(action_space._euler_to_mat(*back),
                                   action_space._euler_to_mat(*rpy),
                                   atol=1e-6)
    vec = np.array([0.01, -0.02, 0.03])
    ax, angle = action_space.euler2axangle(
        *action_space.convert_axangle_to_rpy(vec))
    np.testing.assert_allclose(ax * angle, vec, atol=1e-12)
    np.testing.assert_array_equal(
        action_space.convert_axangle_to_rpy(np.zeros(3)), np.zeros(3))


@pytest.mark.parametrize("temp", [0.0, 0.5])
def test_batch_action_ensembler_matches_jax(temp):
    rng = np.random.default_rng(2)
    got = action_ensemble.BatchActionEnsembler(3, temp)
    ref = jensemble.BatchActionEnsembler(3, temp)
    for t in range(6):
        if t == 4:
            got.reset()
            ref.reset()
        chunk = rng.standard_normal((5, 3, 7)).astype(np.float32)
        out = got.ensemble_action(chunk)
        np.testing.assert_array_equal(out, ref.ensemble_action(chunk))
        assert out.shape == (5, 7)
    # a batch row ensembles as the single-environment ensembler does
    single = action_ensemble.ActionEnsembler(3, temp)
    chunks = rng.standard_normal((4, 5, 3, 7))
    batch = action_ensemble.BatchActionEnsembler(3, temp)
    for c in chunks:
        np.testing.assert_allclose(batch.ensemble_action(c)[1],
                                   single.ensemble_action(c[1]), rtol=1e-12)


def _trajectory(rng, n=24, with_proprio=False):
    """A chunked trajectory's actions and a policy's predictions, the
    gripper switching within it so every mask has members."""
    actions = rng.standard_normal((n, 2, 7)).astype(np.float32) * 0.05
    grip = (np.arange(n) % 12 >= 6).astype(np.float32)
    actions[..., -1] = grip[:, None]
    pred = actions + rng.standard_normal(actions.shape).astype(
        np.float32) * 0.03
    pred[..., -1] = np.roll(grip, 1)[:, None]
    info = dict(actions=actions, pred_actions=pred,
                unnorm_actions=actions * 2.0, unnorm_pred_actions=pred * 2.0)
    if with_proprio:
        info["unnorm_proprio"] = rng.standard_normal((n, 8)) * 0.01
    return info


@pytest.mark.parametrize("with_proprio", [False, True])
def test_manipulation_metrics_and_breakdowns_match_jax(with_proprio):
    info = _trajectory(np.random.default_rng(3), with_proprio=with_proprio)
    got = viz.add_manipulation_metrics(dict(info))
    ref = jviz.add_manipulation_metrics(dict(info))
    _assert_same(got, ref)
    assert "early_gripped_height_aware" in got if with_proprio else True
    breakdown = viz.masked_breakdowns(got)
    assert breakdown == jviz.masked_breakdowns(ref)
    assert "mse_where_gripping" in breakdown and "xyz_angle" in breakdown
    mean, std = np.full(7, 0.5), np.full(7, 2.0)
    mask = np.array([True] * 6 + [False])
    np.testing.assert_array_equal(
        viz.unnormalize(info["actions"], mean, std, mask),
        jviz.unnormalize(info["actions"], mean, std, mask))


class _Dataset(list):
    """Trajectories with the dataset statistics a Visualizer reads."""

    dataset_statistics = {"action": {"mean": np.full(7, 0.1),
                                     "std": np.full(7, 2.0),
                                     "mask": np.array([True] * 6 + [False])}}


def _trajectories(n_trajs=3, length=16):
    rng = np.random.default_rng(4)
    out = []
    for i in range(n_trajs):
        strings = np.array([b"pick up the cube" if i % 2 else
                            b"close top drawer"] * length, dtype=object)
        out.append({
            "observation": {
                "image_primary": rng.integers(0, 256, (length, 1, 8, 8, 3),
                                              dtype=np.uint8),
                "timestep_pad_mask": np.ones((length, 1), bool)},
            "task": {"language_instruction": strings},
            "action": _trajectory(rng, length)["actions"][:, None],
        })
    return out


def _policy(observations, tasks):
    """A deterministic function of the frames and instruction ids."""
    images = np.asarray(observations["image_primary"], np.float32)
    ids = np.asarray(tasks["language_instruction"]["input_ids"], np.float32)
    base = images.mean(axis=(1, 2, 3, 4)) / 255.0 + ids.mean() * 1e-6
    return np.stack([np.outer(base, np.linspace(-1, 1, 7))] * 2, axis=1)


@pytest.mark.parametrize("stats", [True, False])
def test_visualizer_metrics_match_jax(stats):
    trajs = _trajectories()
    data = _Dataset(trajs) if stats else list(trajs)
    got = viz.Visualizer(data, text_processor=_Tokenizer(FallbackTokenizer))
    ref = jviz.Visualizer(data, text_processor=_Tokenizer(JaxTok))
    metrics = got.metrics_for_wandb(_policy, n_trajs=2)
    assert metrics == ref.metrics_for_wandb(_policy, n_trajs=2)
    assert len(got._cached) == 2 and "mse" in metrics
    assert all(np.isfinite(v) for v in metrics.values())
    # the cache serves the same trajectories again
    assert got.metrics_for_wandb(_policy, n_trajs=2) == metrics
    raw = got.raw_evaluations(_policy, n_trajs=2)
    _assert_same(raw, ref.raw_evaluations(_policy, n_trajs=2))
    figures = got.visualize_for_wandb(_policy, n_trajs=1)
    assert list(figures) == list(ref.visualize_for_wandb(_policy,
                                                         n_trajs=1))
    import matplotlib.pyplot as plt

    plt.close("all")


class _Tokenizer:
    """A text processor over a package's FallbackTokenizer."""

    def __init__(self, cls):
        self.tokenizer = cls()

    def encode(self, strings):
        return self.tokenizer(strings, max_length=8)


class _DictObs:
    """PixelReachEnv with dict observations {"image_primary": frame}, and
    the scripted expert's action from its state."""

    def __init__(self, env):
        self.env = env

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        return {"image_primary": obs}, info

    def step(self, action):
        obs, *rest = self.env.step(action)
        return ({"image_primary": obs}, *rest)

    def close(self):
        pass


def test_rollout_visualizer_matches_jax():
    out = {}
    for name, module, pixel in (("jax", jviz, jpixel),
                                ("port", viz, pixel_env)):
        env = _DictObs(pixel.PixelReachEnv(seed=0, max_steps=30))

        def expert(obs, env=env, pixel=pixel):
            return pixel.scripted_expert(env.env._agent, env.env._goal)

        rollouts = module.RolloutVisualizer(lambda env=env: env,
                                            max_episode_length=25)
        out[name] = rollouts.run_rollouts(expert, n_rollouts=3,
                                          n_vis_rollouts=2)
    _assert_same(out["port"], out["jax"])
    metrics, videos = out["port"]
    # the expert reaches the goal before the cap (success_rate counts
    # positive returns, and a reach pays -distance a step before it)
    assert metrics["rollout/mean_length"] < 25 and len(videos) == 2
    assert videos[0].shape[1:] == (64, 64, 3)


def test_rollout_callback_matches_jax(caplog):
    """The training callback over RolloutVisualizers: the same metrics in
    both packages; a rollout whose environment cannot be built is skipped
    with a warning in both."""
    def broken():
        raise RuntimeError("no simulator here")

    out = {}
    for name, module, pixel, callback in (
            ("jax", jviz, jpixel, JaxCallback),
            ("port", viz, pixel_env, RolloutCallback)):
        env = _DictObs(pixel.PixelReachEnv(seed=1, max_steps=30))

        def builder(params, env=env, pixel=pixel):
            assert params == "params"
            return lambda obs: pixel.scripted_expert(env.env._agent,
                                                     env.env._goal)

        visualizers = [
            module.RolloutVisualizer(lambda env=env: env, name="reach",
                                     max_episode_length=25),
            module.RolloutVisualizer(broken, name="simpler")]
        with caplog.at_level("WARNING"):
            out[name] = callback(visualizers, builder, n_rollouts=2)(
                "params", step=5)
    assert out["port"] == out["jax"]
    assert set(out["port"]) == {"reach/mean_return", "reach/mean_length",
                                "reach/success_rate"}
    assert caplog.text.count("rollout simpler skipped") == 2
