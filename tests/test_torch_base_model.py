"""The BaseModel ablation (hypervla_tpu_torch/models/base_model.py,
configs.py::base_pretrain_config) against the JAX package's, on the same
numpy inputs and the JAX params carried across, in fp32 to 1e-5:

  * the config: every field of the port's copy is the JAX config's (the
    fields it leaves out are those its flagship config leaves out), and
    the command line reads it by name;
  * BaseModel on the tiny DINOv2 config of the ablation (every block
    shared, no initial image, the trunk fine-tuned): create_tasks returns
    the params, sample_actions gives the JAX actions, an rng of None
    raises the JAX ValueError, a save/load round trip is bit-equal;
  * the InferenceWrapper's host path serving a BaseModel, tick for tick
    against the JAX wrapper serving the JAX one;
  * the trainer's view of the ablation, a HyperVLA whose blocks are all
    shared: the plan and one train step (loss, grad_norm, every gradient)
    against the JAX step.
"""
import json

import jax
import numpy as np
import pytest
import torch

from hypervla_tpu.configs import flagship_pretrain_config as jax_flagship
from hypervla_tpu.configs import tiny_test_config as jax_tiny_config
from hypervla_tpu.eval.inference import InferenceWrapper as JaxWrapper
from hypervla_tpu.flagship import make_flagship_batch as jax_batch
from hypervla_tpu.models.base_model import BaseModel as JaxBaseModel
from hypervla_tpu_torch.configs import (
    base_pretrain_config,
    flagship_pretrain_config,
    tiny_test_config,
)
from hypervla_tpu_torch.eval.inference import InferenceWrapper
from hypervla_tpu_torch.flagship import make_flagship_batch
from hypervla_tpu_torch.models.base_model import BaseModel
from hypervla_tpu_torch.models.draws import Draws
from hypervla_tpu_torch.models.hypervla import _jsonable
from hypervla_tpu_torch.train.main import BUILTIN_CONFIGS, load_config
from hypervla_tpu_torch.utils.convert import from_jax_params
from scripts.configs import base_pretrain_config as jax_base_config
from test_torch_finetune_step import _flat
from test_torch_harness import torch_threads  # noqa: F401
from test_torch_jax_draws import (
    PAIR_BATCH,
    assert_grads_close,
    build_pair,
    dropout_keys,
    jax_reference,
    port_step_grads,
)

TOL = dict(rtol=1e-5, atol=1e-5)
BATCH = 4
STATS = {"action": {"mean": np.linspace(-0.1, 0.1, 7).astype(np.float32),
                    "std": np.linspace(0.5, 1.5, 7).astype(np.float32),
                    "mask": np.array([True] * 6 + [False])}}


def ablation(config):
    """What base_pretrain_config changes in the recipe it copies."""
    config["model_class"] = "base_model"
    config["hypernet_kwargs"]["share_all_params"] = True
    config["hypernet_kwargs"]["use_initial_image"] = False
    config["base_net_kwargs"]["vit_kwargs"][
        "fine_tune_pretrained_image_encoder"] = True


def test_base_pretrain_config_matches_jax():
    ref = _flat(jax_base_config.get_config("vit_t,oxe").to_dict())
    got = base_pretrain_config("vit_t,oxe")
    flat = _flat(got)
    for key, value in flat.items():
        assert key in ref and ref[key] == value, key
    cut = set(_flat(jax_flagship())) - set(_flat(flagship_pretrain_config()))
    assert set(ref) - set(flat) == cut
    assert BUILTIN_CONFIGS["base_pretrain_config"] is base_pretrain_config
    for name in ("base_pretrain_config",
                 "scripts/configs/base_pretrain_config.py"):
        assert load_config(f"{name}:vit_t,oxe") == got
    fast = base_pretrain_config("vit_t,oxe,fast")
    assert fast["base_net_kwargs"]["vit_kwargs"]["dino_fused_attention"]
    other = base_pretrain_config("vit_t,libero")["dataset_kwargs"]
    assert other["dataset"] == "libero" and other["oxe_mix"] is None


@pytest.fixture(scope="module")
def models():
    jconfig, config = jax_tiny_config("DINOv2"), tiny_test_config()
    for c in (jconfig, config):
        ablation(c)
    jbatch, batch = (jax_batch(batch_size=2, **PAIR_BATCH),
                     make_flagship_batch(batch_size=2, **PAIR_BATCH))
    jmodel = JaxBaseModel.from_config(jconfig, jbatch,
                                      dataset_statistics=STATS)
    rng = np.random.default_rng(0)
    jparams = jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + rng.standard_normal(v.shape) * 0.05
                   ).astype(np.float32), jmodel.params)
    jmodel = jmodel.replace(params=jparams)
    model = BaseModel.from_config(config, batch, device="cpu",
                                  dataset_statistics=STATS)
    ported = from_jax_params(jparams)
    assert {k: tuple(v.shape) for k, v in ported.items()} == {
        k: tuple(v.shape) for k, v in model.params.items()}
    model.params = ported
    return jmodel, model, jbatch, batch


def test_sample_actions_match_jax(models):
    jmodel, model, jbatch, batch = models
    instr = {"language_instruction": jbatch["task"]["language_instruction"]}
    jparams, jtask, jstate = jmodel.create_tasks(instruction_dict=instr)
    assert jparams is jmodel.params and jtask is None and jstate is None
    want, _ = jmodel.sample_actions(
        jbatch["observation"]["image_primary"], instr, None,
        jbatch["observation"]["timestep_pad_mask"], jparams,
        rng=jax.random.PRNGKey(0))
    params, task = model.create_tasks(instruction_dict=instr)
    assert params is model.params and task is None
    got = model.sample_actions(batch["observation"]["image_primary"], instr,
                               None, None, params, rng=torch.Generator(),
                               trunk_impl="layers")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="rngs"):
        jmodel.sample_actions(
            jbatch["observation"]["image_primary"], instr, None,
            jbatch["observation"]["timestep_pad_mask"], jparams)
    with pytest.raises(ValueError, match="rngs"):
        model.sample_actions(batch["observation"]["image_primary"], instr,
                             None, None, params)


@pytest.mark.parametrize("train", [True, False])
def test_an_explicit_train_fails_as_in_jax(models, train):
    """The JAX BaseModel.sample_actions is a bare jax.jit, so any explicit
    train raises jax.errors.TracerBoolConversionError (a TypeError), as
    HyperVLA's does (tests/test_torch_host_path.py); so does the port's."""
    jmodel, model, jbatch, batch = models
    instr = {"language_instruction": jbatch["task"]["language_instruction"]}
    with pytest.raises(TypeError, match="boolean conversion") as jerr:
        jmodel.sample_actions(
            jbatch["observation"]["image_primary"], instr, None,
            jbatch["observation"]["timestep_pad_mask"], jmodel.params,
            train=train, rng=jax.random.PRNGKey(0))
    assert type(jerr.value).__name__ == "TracerBoolConversionError"
    with pytest.raises(TypeError, match="boolean conversion") as err:
        model.sample_actions(batch["observation"]["image_primary"], instr,
                             None, None, model.params, train=train,
                             rng=torch.Generator())
    assert type(err.value).__name__ == "TracerBoolConversionError"


def test_save_and_load_round_trip(models, tmp_path):
    _, model, _, batch = models
    model.save_pretrained(3, checkpoint_path=str(tmp_path))
    loaded = BaseModel.load_pretrained(str(tmp_path), device="cpu")
    assert set(loaded.params) == set(model.params)
    for name, value in model.params.items():
        assert torch.equal(loaded.params[name], value), name
    assert loaded.config == json.loads(json.dumps(_jsonable(model.config)))
    np.testing.assert_array_equal(loaded.dataset_statistics["action"]["std"],
                                  STATS["action"]["std"])
    args = (batch["observation"]["image_primary"], None, None, None)
    np.testing.assert_array_equal(
        loaded.sample_actions(*args, loaded.params, rng=torch.Generator(),
                              trunk_impl="layers").numpy(),
        model.sample_actions(*args, model.params, rng=torch.Generator(),
                             trunk_impl="layers").numpy())
    with pytest.raises(ValueError, match="exactly one"):
        model.save_pretrained(3)


def test_inference_wrapper_serves_it_as_jax_does(models):
    """The host path, three ticks of 224-px frames, against the JAX
    wrapper's (the mix head reads no rng; the wrapper hands one)."""
    jmodel, model, jbatch, _ = models
    instr = {"language_instruction": {
        k: v[:1] for k, v in jbatch["task"]["language_instruction"].items()}}
    frames = np.random.default_rng(2).integers(0, 256, (3, 224, 224, 3),
                                               dtype=np.uint8)
    ref = JaxWrapper(jmodel, image_size=224, pred_action_horizon=2)
    got = InferenceWrapper(model, image_size=224, pred_action_horizon=2,
                           trunk_impl="layers")
    ref.reset("task", instr)
    got.reset("task", instr)
    for frame in frames:
        want = ref.step(frame)
        out = got.step(frame)
        np.testing.assert_allclose(out[0], np.asarray(want[0]), **TOL)
        np.testing.assert_allclose(out[1], np.asarray(want[1]), **TOL)


@pytest.fixture(scope="module")
def pair():
    return build_pair(ablation, batch_size=BATCH)


def test_all_shared_plan_and_train_step_match_jax(pair):
    jmodel, jconfig, model, config, jbatch, batch = pair
    assert not any(model.plan.generation_flag.values())
    md = jmodel.base_net_metadata
    assert md["block_num"] == model.plan.block_num
    assert md["total_param_num"] == model.plan.total_param_num
    ref = jax_reference(jmodel, jconfig, jbatch,
                        dropout_keys(jax.random.PRNGKey(0), BATCH))
    info, grads = port_step_grads(model, config, batch,
                                  Draws(replay=ref["sites"]))
    np.testing.assert_allclose(info["training_loss"], ref["loss"], rtol=1e-5)
    grad_norm = float(np.sqrt(sum((np.asarray(g, np.float64) ** 2).sum()
                                  for g in ref["grads"].values())))
    np.testing.assert_allclose(info["grad_norm"], grad_norm, rtol=1e-5)
    assert_grads_close(grads, ref["grads"])
