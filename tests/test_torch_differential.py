"""Differential attention (hypervla_tpu_torch/models/attention.py::
differential_attention) against the JAX DifferentialAttention on the same
numpy inputs and the JAX params carried across, in fp32 to 1e-5: with a
bool, an integer, a float and no mask, at several depths, with K and V
shared by fewer heads (num_kv_heads); then the switch in the policy
transformer, in the Octo block transformer, and the tiny DINOv2 HyperVLA
with differential attention as a whole: the weight plan (names, flat
offsets, token indices) against the JAX WeightPlan, create_tasks,
sample_actions and one train step (loss, grad_norm, every gradient).
The aux losses read the differential map, whose entries can be negative:
the entropy's log of them is NaN in both packages. The full-width
flagship's plan is held to the JAX one without compiling anything
(jax.jit stood in by jax.eval_shape while the JAX plan is derived).
"""
import jax
import numpy as np
import pytest
import torch

from hypervla_tpu.configs import flagship_pretrain_config as jax_flagship
from hypervla_tpu.models import attention as jattn
from hypervla_tpu.models import block_transformer as jbt
from hypervla_tpu.models.transformer import Transformer as JaxTransformer
from hypervla_tpu_torch.configs import flagship_pretrain_config
from hypervla_tpu_torch.flagship import make_flagship_batch
from hypervla_tpu_torch.models import attention as attn
from hypervla_tpu_torch.models import block_transformer as bt
from hypervla_tpu_torch.models.draws import Draws
from hypervla_tpu_torch.models.transformer import (
    transformer,
    transformer_specs,
)
from hypervla_tpu_torch.models.weight_plan import build_weight_plan
from hypervla_tpu_torch.utils.convert import from_jax_params
from test_torch_harness import torch_threads  # noqa: F401
from test_torch_jax_draws import (
    assert_grads_close,
    build_pair,
    dropout_keys,
    jax_reference,
    port_step_grads,
    with_config,
)
from test_torch_octo_layers import _groups, _perturbed

TOL = dict(rtol=1e-5, atol=1e-5)
EMBED = 32
BATCH = 4


def differential(config):
    config["base_net_kwargs"]["vit_kwargs"][
        "use_differential_transformer"] = True


def _ported(params, prefix):
    return {f"{prefix}/{k}": v for k, v in from_jax_params(params).items()}


def _mask(kind, rng, seq):
    if kind is None:
        return None
    keep = rng.random((2, 1, seq, seq)) > 0.3
    keep[..., 0] = True
    if kind == "bool":
        return keep
    if kind == "int":
        return keep.astype(np.int32)
    return np.where(keep, 0.0, -3.0).astype(np.float32)


@pytest.mark.parametrize("mask", [None, "bool", "int", "float"])
@pytest.mark.parametrize("heads,kv_heads,depth", [(4, None, 0), (4, 2, 3),
                                                  (2, 1, 7)])
def test_differential_attention_matches_jax(mask, heads, kv_heads, depth):
    rng = np.random.default_rng(depth)
    x = rng.standard_normal((2, 6, EMBED)).astype(np.float32)
    m = _mask(mask, rng, 6)
    ref = jattn.DifferentialAttention(embed_dim=EMBED, num_heads=heads,
                                      num_kv_heads=kv_heads, depth=depth)
    variables = _perturbed(ref.init(jax.random.PRNGKey(depth), x, m),
                           seed=depth)
    want, want_map = ref.apply(variables, x, m)
    params = _ported(variables["params"], "a")
    specs = attn.differential_attention_specs("a", EMBED, heads, kv_heads)
    assert {k: tuple(s) for k, (s, _) in specs.items()} == {
        k: tuple(v.shape) for k, v in params.items()}
    got, got_map = attn.differential_attention(
        params, "a", torch.tensor(x), None if m is None else torch.tensor(m),
        EMBED, heads, kv_heads, depth)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_map.numpy(), np.asarray(want_map), **TOL)
    assert attn.lambda_init_fn(depth) == jattn.lambda_init_fn(depth)


def test_the_map_is_a_difference_with_negative_entries():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 5, EMBED)).astype(np.float32)
    ref = jattn.DifferentialAttention(embed_dim=EMBED, num_heads=2)
    variables = _perturbed(ref.init(jax.random.PRNGKey(0), x), scale=0.5)
    _, got = attn.differential_attention(
        _ported(variables["params"], "a"), "a", torch.tensor(x), None,
        EMBED, 2)
    assert float(got.min()) < 0
    # each row is a1 - lambda * a2 of two distributions: it sums to
    # 1 - lambda, the same for every row
    sums = got.sum(-1)
    np.testing.assert_allclose(sums.numpy(), sums.numpy().flat[0], atol=1e-5)


def test_rms_norm_matches_jax():
    x = np.random.default_rng(1).standard_normal((2, 3, 8)).astype(
        np.float32)
    w = np.linspace(0.5, 1.5, 8).astype(np.float32)
    want = jattn.RMSNorm(8).apply({"params": {"weight": w}}, x)
    got = attn.rms_norm(torch.tensor(x), torch.tensor(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("learnable_norm", [True, False])
def test_transformer_switch_matches_jax(learnable_norm):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, EMBED)).astype(np.float32)
    mask = _mask("bool", rng, 7)
    ref = JaxTransformer(embedding_dim=EMBED, num_layers=3, mlp_dim=48,
                         num_attention_heads=2, learnable_norm=learnable_norm,
                         use_differential_transformer=True,
                         dropout_rate=0.0, attention_dropout_rate=0.0)
    variables = _perturbed(ref.init(jax.random.PRNGKey(0), x, mask,
                                    train=False))
    want, want_map = ref.apply(variables, x, mask, train=False)
    params = _ported(variables["params"], "t")
    specs = transformer_specs("t", EMBED, 3, 48, 2,
                              learnable_norm=learnable_norm,
                              use_differential_transformer=True)
    assert {k: tuple(s) for k, (s, _) in specs.items()} == {
        k: tuple(v.shape) for k, v in params.items()}
    maps = []
    got = transformer(params, "t", torch.tensor(x), torch.tensor(mask), 3, 2,
                      maps=maps, learnable_norm=learnable_norm,
                      use_differential_transformer=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the JAX stack returns the last block's map
    np.testing.assert_allclose(maps[-1].numpy(), np.asarray(want_map), **TOL)


def test_block_transformer_switch_matches_jax():
    kwargs = dict(num_layers=2, mlp_dim=32, num_attention_heads=2,
                  dropout_rate=0.0, attention_dropout_rate=0.0,
                  use_differential_transformer=True)
    ref = jbt.BlockTransformer(kwargs, use_correct_attention=True)
    jgroups = _groups(jbt, pad=True)
    variables = _perturbed(ref.init(jax.random.PRNGKey(0), *jgroups,
                                    train=False))
    jprefix, jtimestep = ref.apply(variables, *jgroups, train=False)
    got = bt.BlockTransformer(kwargs, use_correct_attention=True)
    params = _ported(variables["params"], "bt")
    assert {k: tuple(s) for k, (s, _) in got.specs("bt", 16).items()} == {
        k: tuple(v.shape) for k, v in params.items()}
    prefix, timestep = got(params, "bt", *_groups(bt, pad=True))
    for g, j in zip(prefix + timestep, jprefix + jtimestep):
        np.testing.assert_allclose(g.tokens.numpy(), np.asarray(j.tokens),
                                   **TOL)


# --------------------------- the HyperVLA twin ---------------------------


@pytest.fixture(scope="module")
def pair():
    return build_pair(differential, batch_size=BATCH)


def _offsets(names, shapes):
    out, at = {}, 0
    for name in names:
        out[name] = at
        at += int(np.prod(shapes[name])) if len(shapes[name]) else 1
    return out


def test_plan_matches_the_jax_weight_plan(pair):
    jmodel, _, model, _, _, _ = pair
    md = jmodel.base_net_metadata
    leaves = jax.tree_util.tree_flatten_with_path(md["param_shape"])[0]
    names = ["/".join(k.key for k in path) for path, _ in leaves]
    shapes = {n: tuple(s) for n, (_, s) in zip(names, leaves)}
    plan = model.plan
    assert names == plan.names
    assert shapes == plan.param_shape
    assert _offsets(names, shapes) == _offsets(plan.names, plan.param_shape)
    tokens = jax.tree_util.tree_flatten_with_path(md["token_index_dict"])[0]
    assert {"/".join(k.key for k in p): t for p, t in tokens} == \
        plan.token_index
    assert md["output_head_info"] == plan.output_head_info
    assert any("DifferentialAttention_0/lambda_q1" in n for n in names)


def test_create_tasks_and_sample_actions_match_jax(pair):
    jmodel, _, model, _, jbatch, batch = pair
    instr = {"language_instruction": {
        k: v[:1] for k, v in jbatch["task"]["language_instruction"].items()}}
    initial = {"patch_embeddings": jbatch["initial_state"][
        "patch_embeddings"][:1]}
    jparams, jtask, _ = jmodel.create_tasks(instruction_dict=instr,
                                            initial_state=initial)
    want, _ = jmodel.sample_actions(
        jbatch["observation"]["image_primary"][:1], instr, jtask,
        jbatch["observation"]["timestep_pad_mask"][:1], jparams,
        rng=jax.random.PRNGKey(0))
    params, task = model.create_tasks(instruction_dict=instr,
                                      initial_state=initial)
    got = model.sample_actions(batch["observation"]["image_primary"][:1],
                               instr, task, None, params,
                               trunk_impl="layers")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_train_step_matches_jax(pair):
    jmodel, jconfig, model, config, jbatch, batch = pair
    ref = jax_reference(jmodel, jconfig, jbatch,
                        dropout_keys(jax.random.PRNGKey(0), BATCH))
    info, grads = port_step_grads(model, config, batch,
                                  Draws(replay=ref["sites"]))
    np.testing.assert_allclose(info["training_loss"], ref["loss"], rtol=1e-5)
    grad_norm = float(np.sqrt(sum((np.asarray(g, np.float64) ** 2).sum()
                                  for g in ref["grads"].values())))
    np.testing.assert_allclose(info["grad_norm"], grad_norm, rtol=1e-5)
    assert_grads_close(grads, ref["grads"])


def test_entropy_aux_loss_on_the_differential_map_is_jax_s(pair):
    """attention_entropy > 0 takes the log of the map's negative entries:
    NaN in the JAX step, NaN here; the alignment loss stays finite and
    agrees."""
    def aux(entropy, alignment):
        def change(config):
            config["auxiliary_loss"].update(attention_entropy=entropy,
                                            attention_map_alignment=alignment)
        return change

    keys = dropout_keys(jax.random.PRNGKey(0), BATCH)
    for entropy, alignment in ((0.1, 0.0), (0.0, 0.2)):
        jmodel, jconfig, model, config, jbatch, batch = with_config(
            pair, aux(entropy, alignment))
        if alignment:
            ref_map = np.random.default_rng(3).random(
                (BATCH, 2, 1, model.base_net.encoder.n_patch + 1)
            ).astype(np.float32)
            for b in (jbatch, batch):
                b["observation"] = dict(
                    b["observation"], DINO_last_layer_attention_map=ref_map)
        ref = jax_reference(jmodel, jconfig, jbatch, keys, grad=False)
        info, _ = port_step_grads(model, config, batch,
                                  Draws(replay=ref["sites"]))
        if entropy:
            assert np.isnan(ref["loss"]) and np.isnan(info["training_loss"])
        else:
            assert np.isfinite(ref["loss"])
            np.testing.assert_allclose(info["training_loss"], ref["loss"],
                                       rtol=1e-5)


def test_full_width_flagship_plan_matches_jax(monkeypatch):
    """The vit_t,oxe recipe with differential attention at full width: the
    port's plan against the JAX plan, derived with jax.jit stood in by
    jax.eval_shape (the init's shapes, nothing compiled)."""
    from hypervla_tpu.models.weight_plan import init_base_net as jax_plan

    monkeypatch.setattr(jax, "jit", lambda fn, **_: (
        lambda *args: jax.eval_shape(fn, *args)))
    jconfig, config = jax_flagship(), flagship_pretrain_config()
    for c in (jconfig, config):
        differential(c)
    batch = make_flagship_batch()
    _, _, _, md = jax_plan(jconfig, batch, jax.random.PRNGKey(0))
    from hypervla_tpu_torch.models.base_network import BaseNetwork
    from hypervla_tpu_torch.models.weight_plan import input_shapes

    base_net = BaseNetwork(**config["base_net_kwargs"],
                           octo_kwargs=config.get("model"),
                           input_shapes=input_shapes(batch))
    plan = build_weight_plan(config, base_net)
    leaves = jax.tree_util.tree_flatten_with_path(md["param_shape"])[0]
    names = ["/".join(k.key for k in path) for path, _ in leaves]
    assert names == plan.names
    assert {n: tuple(s) for n, (_, s) in zip(names, leaves)} == \
        plan.param_shape
    assert md["total_param_num"] == plan.total_param_num
    tokens = jax.tree_util.tree_flatten_with_path(md["token_index_dict"])[0]
    assert {"/".join(k.key for k in p): t for p, t in tokens} == \
        plan.token_index
    assert tuple(md["layer_token_mask"]) == plan.layer_token_mask
    assert md["output_head_info"] == plan.output_head_info
