"""The EfficientNet backbone (hypervla_tpu_torch/models/efficientnet.py)
and the policy ViT's "EfficientNet" branch against the JAX package, on the
same numpy inputs and the JAX params carried across, in fp32 to 1e-5:

  * the block plans of b0-b7, field by field (pure Python), and the
    scaling rules;
  * the forward of a tiny ModelConfig on 33-px frames, where every
    stride-2 "SAME" convolution pads one pixel more on the high side;
  * the tiny DINOv2 twin with encoder_type EfficientNet (the hard-coded
    efficientnet-b3 swapped for the tiny config in both packages while
    the file runs), its backbone shared and, under share_layer_index,
    generated per task: the weight plan, create_tasks and one train step
    (loss, grad_norm, every gradient), the JAX step's "drop_connect"
    draws (its base-net key split as the JAX train step splits it)
    replayed by site;
  * serving: the JAX sample_actions gives the backbone no "drop_connect"
    stream, and its first block that could drop its branch raises
    InvalidRngError; so does the port's;
  * the full-width EfficientNet-b3 flagship's plan against the JAX plan,
    derived with jax.jit stood in by jax.eval_shape (nothing compiled),
    and an unshared backbone without share_layer_index: AssertionError in
    both.
"""
import dataclasses

import flax
import jax
import numpy as np
import pytest
import torch

import test_torch_jax_draws as jd
from hypervla_tpu.configs import flagship_pretrain_config as jax_flagship
from hypervla_tpu.configs import tiny_test_config as jax_tiny_config
from hypervla_tpu.models import efficientnet as jeff
from hypervla_tpu_torch.configs import (
    flagship_pretrain_config,
    tiny_test_config,
)
from hypervla_tpu_torch.flagship import make_flagship_batch
from hypervla_tpu_torch.models import efficientnet as eff
from hypervla_tpu_torch.models.base_network import BaseNetwork
from hypervla_tpu_torch.models.draws import Draws, InvalidRngError
from hypervla_tpu_torch.models.hypervla import HyperVLA
from hypervla_tpu_torch.models.weight_plan import (
    build_weight_plan,
    input_shapes,
)
from hypervla_tpu_torch.models.layers import init_params, same_padding
from test_torch_differential import _offsets
from test_torch_harness import torch_threads  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
BATCH = 4
SIZE = 300
TINY = dict(width_coefficient=0.25, depth_coefficient=0.5, resolution=SIZE)
#: the twins' backbone: one block that can drop its branch (MBConvBlock_6),
#: at a rate that drops it for some samples
TWIN = dict(width_coefficient=0.25, depth_coefficient=0.3, resolution=SIZE,
            drop_connect_rate=0.6)


def _leaves(tree):
    return {"/".join(k.key for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("name", sorted(jeff.MODEL_CONFIGS))
def test_block_plans_match_jax(name):
    ref = jeff.expand_block_plan(jeff.MODEL_CONFIGS[name])
    got = eff.expand_block_plan(eff.MODEL_CONFIGS[name])
    assert [dataclasses.asdict(b) for b in got] == [
        dataclasses.asdict(b) for b in ref]
    jc, pc = jeff.MODEL_CONFIGS[name], eff.MODEL_CONFIGS[name]
    for filters in (16, 32, 40, 1280):
        assert eff.round_filters(filters, pc) == jeff.round_filters(
            filters, jc)
    assert eff.round_repeats(3, pc.depth_coefficient) == jeff.round_repeats(
        3, jc.depth_coefficient)


@pytest.mark.parametrize("size", [33])
def test_tiny_forward_matches_jax(size):
    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    ref = jeff.EfficientNet(config=jeff.ModelConfig(**TINY))
    shapes = jax.eval_shape(lambda: ref.init(
        {"params": jax.random.PRNGKey(0),
         "drop_connect": jax.random.PRNGKey(1)}, x, train=False))["params"]
    net = eff.EfficientNet(eff.ModelConfig(**TINY))
    assert {f"e/{k}": tuple(v.shape) for k, v in _leaves(shapes).items()} \
        == {k: tuple(s) for k, (s, _) in net.specs("e").items()}
    # the port's init (one JAX compile fewer), perturbed, in both packages
    params = {k: v + 0.02 * torch.randn(v.shape, generator=torch.Generator(
        ).manual_seed(size)) for k, v in init_params(net.specs("e"),
                                                     size).items()}
    tree = {}
    for name, value in params.items():
        *parents, last = name.split("/")[1:]
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = value.numpy()
    want = jax.jit(ref.apply, static_argnames="train")(
        {"params": tree}, x, train=False,
        rngs={"drop_connect": jax.random.PRNGKey(2)})
    got = net(params, "e", torch.tensor(x), train=False,
              draws=Draws(torch.Generator()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert got.shape[1] == eff.output_side(size, net.config)


def test_same_padding_is_xla_s():
    for size, kernel, stride, want in ((33, 3, 2, (1, 1)), (32, 3, 2, (0, 1)),
                                       (224, 7, 2, (2, 3)), (9, 5, 1, (2, 2)),
                                       (8, 1, 2, (0, 0))):
        assert same_padding(size, kernel, stride) == want


# ------------------------------ the twins ------------------------------


def _shared(config):
    config["base_net_kwargs"]["vit_kwargs"]["encoder_type"] = "EfficientNet"
    config["hypernet_kwargs"]["shared_modules"] = ("image_encoder",
                                                   "EfficientNet")


def _generated(config):
    config["base_net_kwargs"]["vit_kwargs"]["encoder_type"] = "EfficientNet"


def _frames(batch):
    rng = np.random.default_rng(11)
    batch["observation"]["image_primary"] = rng.integers(
        0, 256, (batch["action"].shape[0], 1, SIZE, SIZE, 3), dtype=np.uint8)


def _drop_connect_rngs(config, rng):
    """The JAX train step's base-net keys of an EfficientNet policy."""
    rng, drop_connect = jax.random.split(rng)
    return {"dropout": rng, "drop_connect": drop_connect}


@pytest.fixture(scope="module")
def pairs():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jeff.MODEL_CONFIGS, "efficientnet-b3",
                   jeff.ModelConfig(**TWIN))
        mp.setitem(eff.MODEL_CONFIGS, "efficientnet-b3",
                   eff.ModelConfig(**TWIN))
        mp.setattr(jd, "_base_rngs", _drop_connect_rngs)
        yield {"shared": jd.build_pair(_shared, batch_size=BATCH,
                                       batch_change=_frames),
               "generated": jd.build_pair(_generated, batch_size=BATCH,
                                          batch_change=_frames)}


@pytest.mark.parametrize("case", ["shared", "generated"])
def test_plan_matches_the_jax_weight_plan(pairs, case):
    jmodel, _, model, _, _, _ = pairs[case]
    md = jmodel.base_net_metadata
    shapes = {k: tuple(v) for k, v in _leaves(md["param_shape"]).items()}
    assert list(shapes) == model.plan.names
    assert shapes == model.plan.param_shape
    assert _offsets(list(shapes), shapes) == _offsets(
        model.plan.names, model.plan.param_shape)
    assert _leaves(md["token_index_dict"]) == model.plan.token_index
    assert _leaves(md["generation_flag"]) == model.plan.generation_flag
    assert md["output_head_info"] == model.plan.output_head_info
    generated = any(v for k, v in model.plan.generation_flag.items()
                    if "EfficientNet_0" in k)
    assert generated == (case == "generated")


@pytest.mark.parametrize("case", ["shared", "generated"])
def test_train_step_matches_jax(pairs, case):
    jmodel, jconfig, model, config, jbatch, batch = pairs[case]
    ref = jd.jax_reference(jmodel, jconfig, jbatch,
                           jd.dropout_keys(jax.random.PRNGKey(0), BATCH))
    sites = [s for s in ref["sites"] if "MBConvBlock" in s]
    assert sites and all(ref["sites"][s].shape == (BATCH, 1, 1, 1)
                         for s in sites)
    info, grads = jd.port_step_grads(model, config, batch,
                                     Draws(replay=ref["sites"]))
    np.testing.assert_allclose(info["training_loss"], ref["loss"], rtol=1e-5)
    grad_norm = float(np.sqrt(sum((np.asarray(g, np.float64) ** 2).sum()
                                  for g in ref["grads"].values())))
    np.testing.assert_allclose(info["grad_norm"], grad_norm, rtol=1e-5)
    jd.assert_grads_close(grads, ref["grads"])


def test_serving_raises_as_in_jax(pairs):
    jmodel, _, model, _, jbatch, batch = pairs["shared"]
    instr = {"language_instruction": {
        k: v[:1] for k, v in jbatch["task"]["language_instruction"].items()}}
    initial = {"patch_embeddings": jbatch["initial_state"][
        "patch_embeddings"][:1]}
    jparams, jtask, _ = jmodel.create_tasks(instruction_dict=instr,
                                            initial_state=initial)
    with pytest.raises(flax.errors.InvalidRngError) as want:
        jmodel.sample_actions(
            jbatch["observation"]["image_primary"][:1], instr, jtask,
            jbatch["observation"]["timestep_pad_mask"][:1], jparams,
            rng=jax.random.PRNGKey(0))
    params, task = model.create_tasks(instruction_dict=instr,
                                      initial_state=initial)
    with pytest.raises(InvalidRngError) as got:
        model.sample_actions(batch["observation"]["image_primary"][:1],
                             instr, task, None, params)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(want.value).startswith(str(got.value))


def test_full_width_b3_plan_matches_jax_and_unshared_raises(monkeypatch):
    from hypervla_tpu.models.weight_plan import init_base_net as jax_plan

    monkeypatch.setattr(jax, "jit", lambda fn, **_: (
        lambda *args: jax.eval_shape(fn, *args)))
    # the published b3, whatever the twins' fixture has put in its place
    b3 = dict(width_coefficient=1.2, depth_coefficient=1.4, resolution=300,
              dropout_rate=0.3)
    monkeypatch.setitem(jeff.MODEL_CONFIGS, "efficientnet-b3",
                        jeff.ModelConfig(**b3))
    monkeypatch.setitem(eff.MODEL_CONFIGS, "efficientnet-b3",
                        eff.ModelConfig(**b3))
    batch = make_flagship_batch(image_size=SIZE)
    for change in (_generated, _shared):
        jconfig, config = jax_flagship(), flagship_pretrain_config()
        for c in (jconfig, config):
            change(c)
        _, _, _, md = jax_plan(jconfig, batch, jax.random.PRNGKey(0))
        base_net = BaseNetwork(**config["base_net_kwargs"],
                               input_shapes=input_shapes(batch))
        plan = build_weight_plan(config, base_net)
        shapes = {k: tuple(v) for k, v in _leaves(md["param_shape"]).items()}
        assert list(shapes) == plan.names
        assert shapes == plan.param_shape
        assert md["total_param_num"] == plan.total_param_num
        assert _leaves(md["token_index_dict"]) == plan.token_index
        assert _leaves(md["generation_flag"]) == plan.generation_flag
        assert md["output_head_info"] == plan.output_head_info
        assert shapes["encoder/Conv_0/kernel"] == (1, 1, 1536, 64)
    hk = dict(share_layer_index=False, shared_modules=("image_encoder",))
    jconfig = jax_tiny_config("DINOv2", hypernet_kwargs=dict(hk))
    config = tiny_test_config(hypernet_kwargs=dict(hk))
    for c in (jconfig, config):
        _generated(c)
    with pytest.raises(AssertionError, match="Only shared EfficientNet"):
        jax_plan(jconfig, batch, jax.random.PRNGKey(0))
    with pytest.raises(AssertionError, match="Only shared EfficientNet"):
        HyperVLA.from_config(config, batch, device="cpu")
