"""The port's input pipeline (hypervla_tpu_torch/data/) against the JAX
package's (hypervla_tpu/data/) on the CPU.

The fixture is written here, as tests/test_trainer_e2e.py writes its own:
npz trajectories of JPEG frames, instructions that include the drawer
tasks. Both packages build the same datasets from the same kwargs and seed,
with augmentation off: the batches are equal array for array and string for
string, and so are the statistics (each package computes its own:
force_recompute_dataset_statistics). Frames stay at their native size, so
no resize rounding enters; a resize to another size is held to one uint8
level. Both packages tokenize in this one process (FallbackTokenizer's ids
come from Python's salted hash)."""
import io
import json
import os

import numpy as np
import pytest

from hypervla_tpu.data import dataset as jdataset
from hypervla_tpu.data import oxe as joxe
from hypervla_tpu.data.oxe.fixture_mix import (
    register_fixture_mix as jax_register_fixture_mix,
)
from hypervla_tpu.data.sources import NpzTrajectorySource
from hypervla_tpu.data.tfrecord import encode_example, write_tfrecord
from hypervla_tpu.data.tfrecord import read_tfrecord as jax_read_tfrecord
from hypervla_tpu.train import trainer as jtrainer
from hypervla_tpu_torch.data import dataset
from hypervla_tpu_torch.data import oxe
from hypervla_tpu_torch.data import tfrecord, tfrecord_native
from hypervla_tpu_torch.data.oxe.fixture_mix import register_fixture_mix
from hypervla_tpu_torch.train import trainer
from hypervla_tpu_torch.utils.spec import ModuleSpec
from test_torch_harness import torch_threads  # noqa: F401

INSTRUCTIONS = [b"close top drawer", b"pick up the block",
                b"close bottom drawer", b"open the gripper"]
SIZE = (64, 64)


def _jpeg(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG")
    return buf.getvalue()


def _write_dataset(root, name, seed, episodes=4, traj_len=10, size=SIZE):
    rng = np.random.RandomState(seed)
    ds_dir = os.path.join(root, name)
    os.makedirs(ds_dir)
    for ep in range(episodes):
        frames = [_jpeg(rng.randint(0, 255, (*size, 3)).astype(np.uint8))
                  for _ in range(traj_len)]
        NpzTrajectorySource.write_trajectory(
            os.path.join(ds_dir, f"ep_{ep:03d}.npz"),
            {"observation": {"image": np.array(frames, dtype=object)},
             "action": rng.randn(traj_len, 7).astype(np.float32),
             "language_instruction": np.array(
                 [INSTRUCTIONS[(ep + seed) % 4]] * traj_len, dtype=object)})


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pipeline"))
    _write_dataset(root, "fixture_a", 0)
    _write_dataset(root, "fixture_b", 1)
    _write_dataset(root, "fixture_big", 2, size=(80, 96))
    paraphrases = {s.decode(): f"{s.decode()} now. please {s.decode()}"
                   for s in INSTRUCTIONS}
    with open(os.path.join(root, "paraphrases.json"), "w") as f:
        json.dump(paraphrases, f)
    return root


def _kwargs(root, name, **extra):
    return dict(name=name, data_dir=root, image_obs_keys={"primary": "image"},
                language_key="language_instruction",
                action_proprio_normalization_type="normal",
                force_recompute_dataset_statistics=True, **extra)


def assert_tree_equal(got, ref, path=""):
    if isinstance(ref, dict):
        assert isinstance(got, dict) and set(got) == set(ref), path
        for k in ref:
            assert_tree_equal(got[k], ref[k], f"{path}/{k}")
        return
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, path
    if ref.dtype == object:
        assert got.tolist() == ref.tolist(), path
    else:
        np.testing.assert_array_equal(got, ref, err_msg=path)


def _first(pipeline, n):
    it = iter(pipeline)
    return [next(it) for _ in range(n)]


def _interleaved(module, root, names, **extra):
    return module.make_interleaved_dataset(
        [_kwargs(root, n, add_initial_image=True) for n in names],
        [1.0, 2.0][:len(names)],
        train=True, shuffle_buffer_size=20, batch_size=8, seed=3,
        traj_transform_kwargs=dict(window_size=1, action_horizon=2,
                                   max_action_dim=7,
                                   **extra.get("traj", {})),
        frame_transform_kwargs=dict(resize_size=extra.get(
            "resize", {"primary": SIZE})))


def test_single_dataset_matches_jax(root):
    kw = dict(train=True,
              traj_transform_kwargs=dict(window_size=2, action_horizon=3),
              frame_transform_kwargs=dict(resize_size={"primary": SIZE}))
    ref = jdataset.make_single_dataset(_kwargs(root, "fixture_a", seed=0),
                                       **kw)
    got = dataset.make_single_dataset(_kwargs(root, "fixture_a", seed=0),
                                      **kw)
    assert_tree_equal(got.dataset_statistics, ref.dataset_statistics)
    # 3 of the 4 episodes: the train split (dataset.py::_resolve_source)
    for g, r in zip(_first(got, 3), _first(ref, 3)):
        assert g["observation"]["image_primary"].shape == (10, 2, *SIZE, 3)
        assert_tree_equal(g, r)


def test_interleaved_batches_match_jax(root):
    names = ("fixture_a", "fixture_b")
    ref = _interleaved(jdataset, root, names)
    got = _interleaved(dataset, root, names)
    assert_tree_equal(got.dataset_statistics, ref.dataset_statistics)
    np.testing.assert_array_equal(got.sample_weights, ref.sample_weights)
    for g, r in zip(_first(got, 4), _first(ref, 4)):
        assert g["observation"]["image_primary"].shape == (8, 1, *SIZE, 3)
        assert g["initial_state"]["image_primary"].shape == (8, 1, *SIZE, 3)
        assert_tree_equal(g, r)


def test_resize_within_one_level(root):
    """80x96 JPEG frames resized to 64x64 on the host: the lanczos3 resize
    of each package, uint8 within one level (a .5 may round either way)."""
    ref = _first(_interleaved(jdataset, root, ("fixture_big",)), 2)
    got = _first(_interleaved(dataset, root, ("fixture_big",)), 2)
    for g, r in zip(got, ref):
        for part in ("observation", "initial_state"):
            gi = g[part].pop("image_primary").astype(np.int32)
            ri = r[part].pop("image_primary").astype(np.int32)
            assert gi.shape == (8, 1, *SIZE, 3)
            assert np.abs(gi - ri).max() <= 1
        assert_tree_equal(g, r)


def test_rephrase_and_drawer_tasks_match_jax(root):
    """The rephrase augmentation's paraphrases, the host tokenization of
    both instructions and the drawer tasks' masks, through each package's
    make_process_batch and _drawer_task_index."""
    traj = dict(task_augment_strategy="rephrase_instruction",
                task_augment_kwargs=dict(
                    paraphrases_path=os.path.join(root, "paraphrases.json"),
                    rephrase_prob=0.5))
    names = ("fixture_a", "fixture_b")
    ref = _first(_interleaved(jdataset, root, names, traj=traj), 4)
    got = _first(_interleaved(dataset, root, names, traj=traj), 4)
    config = {"dataset_kwargs": {"text_tokenizer": "t5-base",
                                 "tokenizer_max_length": 12}}
    jprocess = jtrainer.make_process_batch(config)
    process = trainer.make_process_batch(config)
    seen_rephrased = drawer = 0
    for g, r in zip(got, ref):
        assert_tree_equal(g, r)
        seen_rephrased += int(np.any(
            g["rephrased_task"]["language_instruction"]
            != g["task"]["language_instruction"]))
        g, r = process(g), jprocess(r)
        assert_tree_equal(g, r)
        g_index = trainer._drawer_task_index(g)
        r_index = jtrainer._drawer_task_index(r)
        assert set(g_index) == set(r_index)
        for name in r_index:
            np.testing.assert_array_equal(g_index[name],
                                          np.asarray(r_index[name]))
            drawer += int(g_index[name].sum())
        g = trainer._prime_example_batch(g, {}, embed=False)
        assert "dataset_name" not in g
        assert "instruction_string" not in g["task"]
    assert seen_rephrased and drawer


def test_oxe_kwargs_match_jax():
    """The OXE registry: the fixture mix and oxe_magic_soup expand to the
    same kwargs and weights; the standardize_fn specs name the port's own
    functions, which resolve."""
    for register in (jax_register_fixture_mix, register_fixture_mix):
        register(3)
    for mix in ("fixture_mix_3", "oxe_magic_soup"):
        kw = dict(load_camera_views=("primary",), skip_unlabeled=True,
                  add_initial_image=True)
        ref, ref_w = joxe.make_oxe_dataset_kwargs_and_weights(mix, "", **kw)
        got, got_w = oxe.make_oxe_dataset_kwargs_and_weights(mix, "", **kw)
        assert got_w == ref_w and len(got) == len(ref) > 0
        for g, r in zip(got, ref):
            g, r = dict(g), dict(r)
            g_spec, r_spec = g.pop("standardize_fn"), r.pop("standardize_fn")
            assert g == r
            assert g_spec["module"].startswith("hypervla_tpu_torch.data.oxe")
            assert g_spec["module"].replace(
                "hypervla_tpu_torch.", "hypervla_tpu.") == r_spec["module"]
            assert (g_spec["name"], g_spec["args"], g_spec["kwargs"]) == (
                r_spec["name"], r_spec["args"], r_spec["kwargs"])
            fn = ModuleSpec.instantiate(g_spec)
            assert fn.func.__module__ == g_spec["module"]


def test_tfrecord_readers_match_jax(tmp_path, monkeypatch):
    """The port's TFRecord readers on a file the JAX package writes: the
    pure-Python copy and the copy of the native reader, which builds
    native/tfrecord_reader.cpp where it lies (here into a temporary
    cache: $HYPERVLA_NATIVE_CACHE, as in the JAX package)."""
    monkeypatch.setenv("HYPERVLA_NATIVE_CACHE", str(tmp_path / "native"))
    path = str(tmp_path / "data.tfrecord")
    write_tfrecord(path, [encode_example({
        "steps/action": np.arange(4, dtype=np.float32) * i,
        "meta": [f"record {i}".encode()]}) for i in range(5)])
    ref = list(jax_read_tfrecord(path, validate_crc=True))
    assert list(tfrecord.read_tfrecord(path, validate_crc=True)) == ref
    assert tfrecord_native.native_available()
    assert (tmp_path / "native" / "libhvtfrecord.so").exists()
    assert list(tfrecord_native.read_tfrecord_native(path)) == ref
    parsed = tfrecord.parse_example(ref[3])
    np.testing.assert_array_equal(parsed["steps/action"],
                                  np.arange(4, dtype=np.float32) * 3)
