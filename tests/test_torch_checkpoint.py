"""The port's checkpoints (hypervla_tpu_torch/models/hypervla.py
save_pretrained / load_pretrained, eval/model_loading.py::
load_hypervla_policy) and tools/convert_checkpoint_to_torch.py, against the
JAX package on the CPU.

The JAX package writes a checkpoint of a tiny fp32 DINOv2 model inside the
test (save_pretrained at step 42 and an EMA_params.pkl of perturbed params,
as its trainer writes them); the tool converts it; both packages'
load_hypervla_policy load it. The JAX model is built, saved and converted
once for the file (about 35 s on a CPU, most of it the JAX init and the
two orbax restores)."""
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from helpers import make_example_batch
from hypervla_tpu.configs import tiny_test_config as jax_tiny_config
from hypervla_tpu.eval.model_loading import (
    load_hypervla_policy as jax_load_policy,
)
from hypervla_tpu.models.hypervla import HyperVLA as JaxHyperVLA
from hypervla_tpu_torch.eval.model_loading import load_hypervla_policy
from hypervla_tpu_torch.models.hypervla import (
    HyperVLA,
    save_ema_params,
)
from hypervla_tpu_torch.utils.convert import from_jax_params
from test_torch_host_path import step_both
from tools.convert_checkpoint_to_torch import convert
from test_torch_harness import torch_threads  # noqa: F401

STATS = {"fractal20220817_data": {"action": {
    "mean": np.arange(7, dtype=np.float32) / 10,
    "std": 1 + np.arange(7, dtype=np.float32) / 7,
    "mask": np.array([True] * 6 + [False]),
}}}
TICKS = 3


def _perturb_heads(params, seed, scale):
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray, params)
    for name, head in params.items():
        if name.startswith("output_head_"):
            head["kernel"] = head["kernel"] + scale * rng.standard_normal(
                head["kernel"].shape).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    batch = make_example_batch(image_size=224, initial_image=True,
                               initial_patch_dim=32, seed=2)
    jmodel = JaxHyperVLA.from_config(
        jax_tiny_config(encoder_type="DINOv2"), batch,
        jax.random.PRNGKey(0), dataset_statistics=STATS)
    params = _perturb_heads(jmodel.params, 0, 0.02)
    jmodel = jmodel.replace(params=params)
    jdir, tdir = str(root / "jax"), str(root / "torch")
    jmodel.save_pretrained(step=42, checkpoint_path=jdir)
    ema = _perturb_heads(params, 1, 0.01)
    with open(os.path.join(jdir, "42", "EMA_params.pkl"), "wb") as f:
        pickle.dump({"EMA_0.999": ema}, f)
    assert convert(jdir, tdir) == [42]
    example = jax.tree_util.tree_map(lambda x: np.asarray(x)[:1], batch)
    instruction = {"language_instruction":
                   example["task"]["language_instruction"]}
    frames = np.random.default_rng(5).integers(
        0, 256, (TICKS, 256, 256, 3), dtype=np.uint8)
    return dict(jdir=jdir, tdir=tdir, params=params, ema=ema,
                instruction=instruction, init=example["initial_state"],
                frames=frames)


def _assert_params_equal(got, want):
    assert set(got) == set(want)
    for name, value in want.items():
        assert torch.equal(got[name].cpu(), value.cpu()), name


def test_converted_checkpoint_serves_as_jax(ckpt):
    """The JAX package's load_hypervla_policy and the port's, on the same
    checkpoint (the port's converted): the EMA params are the ones swapped
    in, create_tasks agrees to 1e-5, and so do the host path's actions
    (the JAX defaults: google_robot, crop, ensembling; the resized frames
    held apart, as tests/test_torch_host_path.py::step_both does)."""
    jpolicy = jax_load_policy(ckpt["jdir"])
    policy = load_hypervla_policy(ckpt["tdir"], device="cpu")
    assert not policy.fused_serving and not jpolicy.fused_serving
    _assert_params_equal(policy.model.params, from_jax_params(ckpt["ema"]))
    trained = from_jax_params(ckpt["params"])
    assert any(not torch.equal(policy.model.params[k], trained[k])
               for k in trained)

    jbase, _, _ = jpolicy.model.create_tasks(
        instruction_dict=ckpt["instruction"], initial_state=ckpt["init"])
    base, _ = policy.model.create_tasks(
        instruction_dict=ckpt["instruction"], initial_state=ckpt["init"])
    ref = {"/".join(k.key for k in path): v for path, v in
           jax.tree_util.tree_flatten_with_path(jbase)[0]}
    assert set(ref) == set(base)
    for name, value in ref.items():
        np.testing.assert_allclose(base[name].numpy(), np.asarray(value),
                                   atol=1e-5, err_msg=name)

    for wrapper in (jpolicy, policy):
        wrapper.reset("pick up the cube", ckpt["instruction"], ckpt["init"])
    for frame in ckpt["frames"]:
        ref, got = step_both(jpolicy, policy, frame)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, atol=1e-5)


def test_ema_decay_none_keeps_the_trained_params(ckpt):
    policy = load_hypervla_policy(ckpt["tdir"], ema_decay=None, device="cpu")
    _assert_params_equal(policy.model.params,
                         from_jax_params(ckpt["params"]))
    policy = load_hypervla_policy(ckpt["tdir"], ema_decay=0.5, device="cpu")
    _assert_params_equal(policy.model.params,
                         from_jax_params(ckpt["params"]))


def test_port_save_load_round_trip_is_bit_equal(ckpt, tmp_path):
    model = HyperVLA.load_pretrained(ckpt["tdir"], device="cpu")
    model.save_pretrained(7, str(tmp_path))
    loaded = HyperVLA.load_pretrained(str(tmp_path), device="cpu")
    _assert_params_equal(loaded.params, model.params)
    assert loaded.config == model.config
    flat = {}
    for tree, out in ((model.example_batch, "a"), (loaded.example_batch, "b")):
        flat[out] = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [p for p, _ in flat["a"]] == [p for p, _ in flat["b"]]
    for (_, a), (_, b) in zip(flat["a"], flat["b"]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    stats = loaded.dataset_statistics["fractal20220817_data"]["action"]
    for key, value in STATS["fractal20220817_data"]["action"].items():
        np.testing.assert_array_equal(stats[key], value)


def test_step_none_takes_the_latest_step(ckpt, tmp_path):
    """Two steps, each with params and an EMA file: step None reads the
    latest of both (11, not 3 and not the lexically larger "3")."""
    model = HyperVLA.load_pretrained(ckpt["tdir"], device="cpu")
    later = {k: v + 1.0 for k, v in model.params.items()}
    model.save_pretrained(3, str(tmp_path))
    model.replace(params=later).save_pretrained(11, str(tmp_path))
    save_ema_params(str(tmp_path), 3, model.params)
    save_ema_params(str(tmp_path), 11, {k: v * 2 for k, v in later.items()})
    _assert_params_equal(
        HyperVLA.load_pretrained(str(tmp_path), device="cpu").params, later)
    _assert_params_equal(
        HyperVLA.load_pretrained(str(tmp_path), step=3, device="cpu").params,
        model.params)
    policy = load_hypervla_policy(str(tmp_path), device="cpu")
    _assert_params_equal(policy.model.params,
                         {k: v * 2 for k, v in later.items()})
    policy = load_hypervla_policy(str(tmp_path), step=3, device="cpu")
    _assert_params_equal(policy.model.params, model.params)


def test_json_round_trip_keeps_lists_and_the_bool_mask(ckpt, tmp_path):
    """config.json turns tuples into lists and dataset_statistics.json
    arrays into lists: the port's config consumers take the lists, and
    the statistics come back as arrays with a bool mask."""
    model = HyperVLA.load_pretrained(ckpt["tdir"], device="cpu")
    config = json.load(open(os.path.join(ckpt["tdir"], "config.json")))
    assert isinstance(config["hypernet_kwargs"]["shared_modules"], list)
    assert model.config == config
    assert model.plan.generation_flag["encoder/image_encoder/embeddings/"
                                      "cls_token"] is False
    stats = model.dataset_statistics["fractal20220817_data"]["action"]
    assert stats["mask"].dtype == np.bool_
    assert stats["std"].dtype == np.float64
    base, _ = model.create_tasks(instruction_dict=ckpt["instruction"],
                                 initial_state=ckpt["init"])
    assert base


def test_load_fills_in_what_older_checkpoints_lack(ckpt, tmp_path):
    """A config without action_head_kwargs and an example batch without a
    token embedding load as the JAX package loads them: the default head
    settings, a zero token embedding of width 768."""
    model = HyperVLA.load_pretrained(ckpt["tdir"], device="cpu")
    model.save_pretrained(1, str(tmp_path))
    config = json.load(open(tmp_path / "config.json"))
    del config["base_net_kwargs"]["action_head_kwargs"]
    json.dump(config, open(tmp_path / "config.json", "w"))
    with np.load(tmp_path / "example_batch.npz") as data:
        flat = {k: data[k] for k in data.files
                if not k.endswith("token_embedding")}
    np.savez(tmp_path / "example_batch.npz", **flat)
    loaded = HyperVLA.load_pretrained(str(tmp_path), device="cpu")
    assert loaded.config["base_net_kwargs"]["action_head_kwargs"] == dict(
        token_per_horizon=False, squash_continuous_action=True,
        clip_target=False, max_action=5.0)
    tokens = loaded.example_batch["task"]["language_instruction"][
        "token_embedding"]
    assert tokens.shape == (1, 8, 768) and not tokens.any()
    _assert_params_equal(loaded.params, model.params)
