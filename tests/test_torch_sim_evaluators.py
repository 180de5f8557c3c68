"""The port's SIMPLER and LIBERO evaluators (hypervla_tpu_torch/eval/
simpler.py, libero.py) against the JAX package's, on the CPU, with the
simulators stood in by tests/test_torch_sim_stubs.py: the protocol cases of
tests/test_sim_evaluators.py run through both packages, which must write
the same success JSON, run the same episodes with the same options and
seeds, skip what is computed, and write the same videos and attention
pickles; `resolve_task_ids` on the libero_90 split.

Then the evaluators over real policies (the tiny fp32 DINOv2 twins of
tests/test_torch_serving.py::_build, conditioned on the initial image):
SIMPLER's `_initial_state` encodes with a DINOv2 of its own, the JAX
package's PRNGKey(0) init, converted and handed to the port's loader;
`window_size=2` (SIMPLER's default) fails at the second step in both
packages; LIBERO's reset without an initial state fails in both; and a
flipped frame (LIBERO's upright view, negative strides) steps as its
contiguous copy."""
import glob
import json
import os
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from helpers import make_example_batch
from hypervla_tpu.eval import libero as jlibero
from hypervla_tpu.eval import simpler as jsimpler
from hypervla_tpu.eval.inference import InferenceWrapper as JaxWrapper
from hypervla_tpu.models.encoders import dinov2 as jdino
from hypervla_tpu.utils.static import static_dict
from hypervla_tpu_torch.eval import libero, simpler
from hypervla_tpu_torch.eval.inference import InferenceWrapper
from hypervla_tpu_torch.utils.convert import from_jax_params
from test_torch_harness import torch_threads  # noqa: F401
from test_torch_preprocess import _assert_close_u8
from test_torch_serving import STATS, _build
from test_torch_sim_stubs import (
    AttentionPolicy,
    MockPolicy,
    install_mock_libero,
    install_mock_simpler,
    mock_suite,
)

PACKAGES = {"jax": (jsimpler, jlibero), "port": (simpler, libero)}
TASKS = {
    "google_robot_close_top_drawer": (None, 4, None),
    "google_robot_move_near": (
        None, 2, [{"obj_init_options": {"episode_id": i}} for i in range(2)]),
}


def _setitem(monkeypatch):
    import sys

    return lambda name, module: monkeypatch.setitem(sys.modules, name,
                                                    module)


def _text_encode(s):
    return {"instruction": s}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_simpler_protocol_matches_jax(tmp_path, monkeypatch):
    out = {}
    for name, (module, _) in PACKAGES.items():
        envs = install_mock_simpler(_setitem(monkeypatch),
                                    episode_success=lambda ep: ep % 2 == 0)
        policy = MockPolicy()
        path = str(tmp_path / name)
        results = module.evaluate(policy, _text_encode, tasks=TASKS,
                                  seed=3, eval_path=path)
        resets = policy.resets
        again = module.evaluate(policy, _text_encode, tasks=TASKS,
                                eval_path=path)
        assert again == results and policy.resets == resets == 6
        env = envs["google_robot_move_near"]
        out[name] = (results, _read(os.path.join(path, "success_rate.json")),
                     env.seen_options, env.seeds,
                     envs["google_robot_close_top_drawer"].seeds)
    assert out["port"] == out["jax"]
    results, _, options, seeds, drawer_seeds = out["port"]
    assert results == {"google_robot_close_top_drawer": 0.5,
                       "google_robot_move_near": 0.5}
    assert options == [{"obj_init_options": {"episode_id": i}}
                       for i in range(2)]
    assert seeds == [3, 4] and drawer_seeds == [3, 4, 5, 6]


def test_libero_protocol_matches_jax(tmp_path, monkeypatch):
    out = {}
    for name, (_, module) in PACKAGES.items():
        made = install_mock_libero(
            _setitem(monkeypatch), {"libero_object": mock_suite(["mock"])})
        results = module.evaluate(MockPolicy(), _text_encode,
                                  eval_path=str(tmp_path / name),
                                  num_episodes=2, seed=5)
        out[name] = (results, _read(tmp_path / name / "libero_object.json"),
                     [e.seeds for e in made],
                     [e.kwargs["camera_heights"] for e in made])
    assert out["port"] == out["jax"]
    assert out["port"][0] == {"mock": 1.0} and out["port"][2] == [[5, 6]]


@pytest.mark.parametrize("kind", ["video", "attention"])
def test_simpler_artifacts_match_jax(tmp_path, monkeypatch, kind):
    files = {}
    for name, (module, _) in PACKAGES.items():
        install_mock_simpler(_setitem(monkeypatch),
                             episode_success=lambda ep: ep == 0)
        path = tmp_path / name
        policy = MockPolicy() if kind == "video" else AttentionPolicy()
        module.evaluate(
            policy, _text_encode,
            tasks={"google_robot_close_top_drawer": (None, 2, None)},
            eval_path=str(path), save_video=kind == "video",
            save_attention_map=kind == "attention")
        files[name] = {os.path.basename(p): _read(p)
                       for p in glob.glob(str(path / "*"))}
    assert files["port"] == files["jax"]
    names = sorted(files["port"])
    if kind == "video":
        assert [n for n in names if "_ep0_succ" in n]
        assert [n for n in names if "_ep1_fail" in n]
    else:
        pkls = [n for n in names if n.endswith("_attention.pkl")]
        assert len(pkls) == 2
        maps = pickle.loads(files["port"][pkls[0]])
        assert maps.shape[1:] == (4, 17, 17)


def test_resolve_task_ids_matches_jax(tmp_path):
    names = ["KITCHEN_open_door", "LIVING_pick_mug", "STUDY_close_book"]
    suite = mock_suite(names)()
    split_file = str(tmp_path / "task_split.pkl")
    with open(split_file, "wb") as f:
        pickle.dump((["STUDY_close_book_demo.hdf5",
                      "KITCHEN_open_door_demo.hdf5"],
                     ["LIVING_pick_mug_demo.hdf5"]), f)
    cases = [
        (("libero_90",), dict(split="train", split_file=split_file), [2, 0]),
        (("libero_90",), dict(split="test", split_file=split_file), [1]),
        (("libero_90",), dict(
            split="single_task",
            model_path="finetune_saves/libero_90/LIVING_pick_mug/seed_0"),
         [1]),
        (("libero_object",), dict(split="train"), [0, 1, 2]),
        (("libero_90",), dict(split=None), [0, 1, 2]),
        (("libero_90",), dict(split="train", task_ids=[2]), [2]),
    ]
    for args, kwargs, want in cases:
        got = libero.resolve_task_ids(suite, *args, **kwargs)
        assert got == jlibero.resolve_task_ids(suite, *args, **kwargs) == want


def test_libero_evaluate_honors_the_split_as_jax(tmp_path, monkeypatch):
    split_file = str(tmp_path / "task_split.pkl")
    with open(split_file, "wb") as f:
        pickle.dump((["task_b_demo.hdf5"], ["task_c_demo.hdf5"]), f)
    out = {}
    for name, (_, module) in PACKAGES.items():
        install_mock_libero(
            _setitem(monkeypatch),
            {"libero_90": mock_suite(["task_a", "task_b", "task_c"])},
            done_after=2)
        out[name] = module.evaluate(
            MockPolicy(), _text_encode, benchmark_name="libero_90",
            eval_path=str(tmp_path / name), num_episodes=1, split="train",
            split_file=split_file)
    assert out["port"] == out["jax"] == {"task_b": 1.0}


def _dinov2_policy(model):
    """A stand-in for a wrapper: what _initial_state reads of it."""
    return types.SimpleNamespace(model=model)


def test_initial_state_encodes_with_its_own_dinov2_as_jax(monkeypatch):
    """The same DINOv2 weights (the JAX evaluator's PRNGKey(0) init handed
    to the port's loader): patch embeddings to 1e-5 on a 224-px frame
    (no resize); on a 256-px one the resized pixels to the resize's
    uint8 bound."""
    monkeypatch.delenv("HYPERVLA_PRETRAINED_DIR", raising=False)
    monkeypatch.setenv("HOME", "/nonexistent")
    config = {"hypernet_kwargs": {"use_initial_image": True},
              "base_net_kwargs": {"vit_kwargs": {
                  "pretrained_encoder_name": "dinov2-test"}}}
    jax_init = jdino.DINOv2Model(
        config=jdino.dinov2_config("dinov2-test")).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)))["params"]
    loaded = []

    def load(name, device=None):
        loaded.append(name)
        return from_jax_params(jax.tree_util.tree_map(np.asarray, jax_init),
                               device)

    monkeypatch.setattr(simpler, "load_dinov2_weights", load)
    jpolicy = _dinov2_policy(types.SimpleNamespace(config=config))
    policy = _dinov2_policy(types.SimpleNamespace(config=config,
                                                  device="cpu"))
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, (224, 224, 3), dtype=np.uint8)
    ref = jsimpler._initial_state(jpolicy, frame)
    got = simpler._initial_state(policy, frame)
    assert loaded == ["dinov2-test"] and got.keys() == ref.keys()
    np.testing.assert_array_equal(got["image_primary"], ref["image_primary"])
    assert got["patch_embeddings"].shape == (1, 257, 32)
    np.testing.assert_allclose(got["patch_embeddings"],
                               np.asarray(ref["patch_embeddings"]),
                               atol=1e-5)
    big = rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
    ref = jsimpler._initial_state(jpolicy, big)["image_primary"]
    got = simpler._initial_state(policy, big)["image_primary"]
    assert got.shape == ref.shape == (1, 1, 224, 224, 3)
    _assert_close_u8(got[0, 0], np.asarray(ref)[0, 0])
    assert loaded == ["dinov2-test"]  # built once per policy
    # without the initial-image conditioning there is no initial state
    plain = {"hypernet_kwargs": {}, "base_net_kwargs": config[
        "base_net_kwargs"]}
    assert simpler._initial_state(_dinov2_policy(types.SimpleNamespace(
        config=plain, device="cpu")), frame) is None
    assert simpler._initial_state(object(), frame) is None


def test_initial_state_without_weights_is_seeded(monkeypatch):
    monkeypatch.delenv("HYPERVLA_PRETRAINED_DIR", raising=False)
    config = {"hypernet_kwargs": {"use_initial_image": True},
              "base_net_kwargs": {"vit_kwargs": {
                  "pretrained_encoder_name": "dinov2-test"}}}
    frame = np.random.default_rng(1).integers(0, 256, (224, 224, 3),
                                              dtype=np.uint8)
    a, b = (simpler._initial_state(_dinov2_policy(types.SimpleNamespace(
        config=config, device="cpu")), frame)["patch_embeddings"]
        for _ in range(2))
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all()


@pytest.fixture(scope="module")
def twins():
    jmodel, _, model, _, _, _ = _build({}, 32)
    example = make_example_batch(image_size=224, initial_image=True,
                                 initial_patch_dim=32, seed=2)
    instruction = {"language_instruction": {
        k: np.asarray(v)[:1]
        for k, v in example["task"]["language_instruction"].items()}}
    stats = {"action": STATS}
    return (jmodel.replace(dataset_statistics=static_dict(stats)),
            model.replace(dataset_statistics=stats), instruction)


class _Counted:
    """A wrapper that counts its steps."""

    def __init__(self, wrapper):
        self.wrapper = wrapper
        self.model = wrapper.model
        self.steps = 0

    def reset(self, *args, **kwargs):
        return self.wrapper.reset(*args, **kwargs)

    def step(self, image):
        self.steps += 1
        return self.wrapper.step(image)


def test_window_size_2_fails_at_the_second_step_in_both(twins, tmp_path,
                                                        monkeypatch):
    """SIMPLER's default window_size=2 gives the wrapper a two-frame
    history, which the ViT base net refuses at the second step (one frame
    in the history runs): ValueError in both packages, after the
    separate DINOv2's initial state."""
    jmodel, model, instruction = twins
    kwargs = dict(policy_setup="google_robot", horizon=2,
                  pred_action_horizon=2, image_size=224)
    for name, policy in (("jax", JaxWrapper(model=jmodel, **kwargs)),
                         ("port", InferenceWrapper(model, **kwargs))):
        module = PACKAGES[name][0]
        install_mock_simpler(_setitem(monkeypatch), lambda ep: False)
        counted = _Counted(policy)
        with pytest.raises(ValueError):
            module.evaluate(
                counted, lambda s: instruction,
                tasks={"google_robot_close_top_drawer": (None, 1, None)},
                eval_path=str(tmp_path / name))
        assert counted.steps == 2, name
        assert policy.num_image_history == 2


def test_reset_without_an_initial_state_fails_in_both(twins, tmp_path,
                                                      monkeypatch):
    """LIBERO resets without an initial state: on a model conditioned on
    the initial image both packages fail at reset with a TypeError."""
    jmodel, model, instruction = twins
    kwargs = dict(policy_setup="libero", pred_action_horizon=2,
                  image_size=224)
    for name, policy in (("jax", JaxWrapper(model=jmodel, **kwargs)),
                         ("port", InferenceWrapper(model, **kwargs))):
        install_mock_libero(_setitem(monkeypatch),
                            {"libero_object": mock_suite(["mock"])})
        with pytest.raises(TypeError):
            PACKAGES[name][1].evaluate(policy, lambda s: instruction,
                                       eval_path=str(tmp_path / name),
                                       num_episodes=1)
        assert not os.path.exists(tmp_path / name / "libero_object.json")


def test_simpler_runs_a_real_policy_as_jax(twins, tmp_path, monkeypatch):
    """window_size 1 and the same DINOv2 weights for the initial state:
    the same JSON and per-step actions within 1e-5 on 64-px zero frames
    (resized to 224 the same in both packages)."""
    jmodel, model, instruction = twins
    jax_init = jdino.DINOv2Model(
        config=jdino.dinov2_config("dinov2-test")).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)))["params"]
    monkeypatch.delenv("HYPERVLA_PRETRAINED_DIR", raising=False)
    monkeypatch.setenv("HOME", "/nonexistent")
    monkeypatch.setattr(
        simpler, "load_dinov2_weights",
        lambda name, device=None: from_jax_params(
            jax.tree_util.tree_map(np.asarray, jax_init), device))
    kwargs = dict(policy_setup="google_robot", pred_action_horizon=2,
                  image_size=224, action_ensemble=True)
    out = {}
    for name, policy in (("jax", JaxWrapper(model=jmodel, **kwargs)),
                         ("port", InferenceWrapper(model, **kwargs))):
        install_mock_simpler(_setitem(monkeypatch), lambda ep: ep == 0)
        actions = []

        class Recording(_Counted):
            def step(self, image):
                result = super().step(image)
                actions.append(np.asarray(result[0]))
                return result

        results = PACKAGES[name][0].evaluate(
            Recording(policy), lambda s: instruction,
            tasks={"google_robot_close_top_drawer": (None, 2, None)},
            eval_path=str(tmp_path / name))
        out[name] = (results, np.stack(actions), json.loads(_read(
            tmp_path / name / "success_rate.json")))
    assert out["port"][0] == out["jax"][0] == out["port"][2] == {
        "google_robot_close_top_drawer": 0.5}
    assert out["port"][1].shape == (6, 7)
    np.testing.assert_allclose(out["port"][1], out["jax"][1], atol=1e-5)


def test_a_flipped_frame_steps_as_its_copy(twins):
    """LIBERO hands the wrapper its frame flipped upright, a view with
    negative strides: the port's wrapper steps on it as on a contiguous
    copy (the JAX one takes any array)."""
    _, model, instruction = twins
    init = {"patch_embeddings": np.zeros((1, 257, 32), np.float32)}
    frame = np.random.default_rng(5).integers(0, 256, (256, 256, 3),
                                              dtype=np.uint8)
    out = []
    for image in (frame[::-1], np.ascontiguousarray(frame[::-1])):
        wrapper = InferenceWrapper(model, policy_setup="libero",
                                   pred_action_horizon=2, image_size=224)
        wrapper.reset("pick up the cube", instruction, init)
        out.append(wrapper.step(image)[:2])
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
