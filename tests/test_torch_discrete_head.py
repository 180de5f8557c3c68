"""The port's discrete action head (hypervla_tpu_torch/models/
action_heads.py::DiscreteActionHead, discrete_loss) and its tokenizer
(models/tokenizers.py::BinTokenizer) against the JAX package's on the CPU
in fp32: the tokens of values on and beside every bin edge for uniform and
normal bins, the head's per-sample loss with its mse and accuracy, the
argmax decode, HyperVLA.sample_actions on the tiny DINOv2 twin and one
train step against the JAX step on a one-device mesh (as
tests/test_torch_smallstem_train_step.py holds its step).

Two recorded differences of the tokenizer:

  * the normal bins' edges are scipy's standard normal quantiles (float64,
    rounded to fp32), the JAX package's jax.scipy.stats.norm.ppf in fp32,
    which is up to a few hundred fp32 ulps off near 0 (1e-6 absolute):
    a value that lies between the two packages' copies of an edge takes
    the bins on either side of it, every other value the same token;
  * XLA on the CPU flushes a denormal input to zero, so the JAX tokenizer
    puts -1.4e-45 in the bin above the edge at 0; the port compares the
    value itself and puts it below, as it puts any negative value.
"""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervla_tpu.models import action_heads as jah
from hypervla_tpu.models.token_group import TokenGroup
from hypervla_tpu.models.tokenizers import BinTokenizer as JaxBinTokenizer
from hypervla_tpu.parallel.mesh import create_mesh
from hypervla_tpu_torch.models import action_heads as ah
from hypervla_tpu_torch.models.base_network import readout_token_count
from hypervla_tpu_torch.models.tokenizers import BinTokenizer
from hypervla_tpu_torch.utils.convert import flatten_tree, from_jax_params
from test_torch_harness import torch_threads  # noqa: F401
from test_torch_jax_draws import build_pair
from test_torch_smallstem_train_step import DEGENERATE
from test_torch_train_step import _cosine, _jax_step, _torch_step

TOL = dict(rtol=1e-5, atol=1e-5)
HORIZON, DIM, EMB, BATCH = 2, 7, 16, 3
#: the normal edges' largest distance from the JAX package's
NORMAL_EDGE_BOUND = 2e-6


def _jax_edges(tokenizer):
    return np.asarray(tokenizer.apply({}, method=lambda m: m.thresholds))


def _values_at_edges(edges):
    """Every edge, the fp32 values just above and below it, the bin
    centres, and values out of range."""
    edges = edges.astype(np.float32)
    return np.concatenate([
        edges, np.nextafter(edges, np.float32(np.inf)),
        np.nextafter(edges, np.float32(-np.inf)),
        (edges[1:] + edges[:-1]) / 2, [-7.0, 7.0, -1.0, 1.0, 0.0]],
    ).astype(np.float32)


def _denormals_beside_zero(values, got, ref):
    """The values beside the edge at 0 are the denormals of the module
    docstring: JAX puts both in the bin above it (128), the port the
    negative one below it. Returns their mask."""
    denormal = (values != 0) & (np.abs(values) < np.finfo(np.float32).tiny)
    assert (np.abs(values[denormal]) == np.float32(1.4e-45)).all()
    assert denormal.sum() >= 2
    np.testing.assert_array_equal(ref[denormal], 128)
    np.testing.assert_array_equal(got[denormal],
                                  np.where(values[denormal] < 0, 127, 128))
    return denormal


def test_uniform_bins_match_jax_at_every_edge():
    jtok, tok = JaxBinTokenizer(bin_type="uniform"), BinTokenizer("uniform")
    edges = _jax_edges(jtok)
    np.testing.assert_array_equal(tok.thresholds.numpy(), edges)
    values = _values_at_edges(edges)
    got = tok(torch.tensor(values)).numpy()
    ref = np.asarray(jtok.apply({}, values))
    denormal = _denormals_beside_zero(values, got, ref)
    np.testing.assert_array_equal(got[~denormal], ref[~denormal])
    tokens = np.arange(256, dtype=np.int32)
    np.testing.assert_array_equal(
        tok.decode(torch.tensor(tokens)).numpy(),
        np.asarray(jtok.apply({}, tokens, method=JaxBinTokenizer.decode)))


def test_normal_bins_match_jax_but_between_the_two_edges():
    jtok, tok = JaxBinTokenizer(bin_type="normal"), BinTokenizer("normal")
    jedges, edges = _jax_edges(jtok), tok.thresholds.numpy()
    np.testing.assert_allclose(edges, jedges, rtol=0, atol=NORMAL_EDGE_BOUND)
    values = np.concatenate([_values_at_edges(jedges),
                             _values_at_edges(edges)])
    ref = np.asarray(jtok.apply({}, values))
    got = tok(torch.tensor(values)).numpy()
    lo, hi = np.minimum(edges, jedges), np.maximum(edges, jedges)
    between = ((values[:, None] >= lo) & (values[:, None] <= hi)
               & (lo != hi)).any(1)
    denormal = _denormals_beside_zero(values, got, ref)
    same = ~between & ~denormal
    np.testing.assert_array_equal(got[same], ref[same])
    assert (np.abs(got[between] - ref[between]) <= 1).all()
    centres = ((jedges[1:] + jedges[:-1]) / 2).astype(np.float32)
    np.testing.assert_array_equal(tok(torch.tensor(centres)).numpy(),
                                  np.asarray(jtok.apply({}, centres)))


def _jax_head(token_per):
    jhead = jah.DiscreteActionHead(readout_key="readout_action",
                                   action_dim=DIM, action_horizon=HORIZON,
                                   token_per=token_per)
    n = readout_token_count("discrete", {"discrete_token_type": token_per},
                            HORIZON, DIM)
    rng = np.random.default_rng(0)
    tokens = rng.standard_normal((BATCH, 1, n, EMB)).astype(np.float32)
    group = {"readout_action": TokenGroup(jnp.asarray(tokens), None)}
    variables = flax.core.unfreeze(jhead.init(jax.random.PRNGKey(0), group,
                                              train=False))
    variables = jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + rng.standard_normal(v.shape)).astype(
            np.float32), variables)
    head = ah.DiscreteActionHead(HORIZON, DIM, token_per=token_per)
    params = {f"action_head/{k}": v for k, v in from_jax_params(
        variables["params"]).items()}
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: tuple(s) for k, (s, _) in head.specs(EMB).items()}
    return jhead, variables, head, params, tokens


@pytest.mark.parametrize("token_per", ["action_dim_and_action_horizon",
                                       "action_horizon"])
def test_loss_accuracy_and_decode_match_jax(token_per):
    """Per sample (the JAX step's vmap), with some action dims and window
    steps masked and targets on bin edges and out of range."""
    jhead, variables, head, params, tokens = _jax_head(token_per)
    rng = np.random.default_rng(1)
    edges = head.tokenizer.thresholds.numpy()
    actions = rng.choice(np.concatenate([edges, [-3.0, 3.0]]),
                         (BATCH, 1, HORIZON, DIM)).astype(np.float32)
    actions[0] = rng.uniform(-1, 1, actions[0].shape)
    pad = np.ones((BATCH, 1), bool)
    action_pad = rng.random((BATCH, 1, HORIZON, DIM)) < 0.8
    losses, metrics = head.loss(params, torch.tensor(tokens),
                                torch.tensor(actions), torch.tensor(pad),
                                torch.tensor(action_pad))
    for i in range(BATCH):
        sample = {"readout_action": TokenGroup(jnp.asarray(tokens[i:i + 1]),
                                               None)}
        loss, ref = jhead.apply(variables, sample, actions[i:i + 1],
                                pad[i:i + 1], action_pad[i:i + 1],
                                train=False, method="loss")
        np.testing.assert_allclose(float(losses[i]), float(loss), **TOL)
        assert set(metrics) == set(ref) == {"loss", "mse", "accuracy"}
        for key, value in ref.items():
            np.testing.assert_allclose(float(metrics[key][i]), float(value),
                                       err_msg=key, **TOL)
    ref = jhead.apply(variables, {"readout_action": TokenGroup(
        jnp.asarray(tokens), None)}, train=False, argmax=True,
        method="predict_action")
    got = head.predict_action(params, torch.tensor(tokens), argmax=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_layouts_and_refusals_match_jax():
    for token_per, n in (("action_dim_and_action_horizon", HORIZON * DIM),
                         ("action_horizon", HORIZON)):
        assert readout_token_count("discrete", {
            "discrete_token_type": token_per}, HORIZON, DIM) == n
    with pytest.raises(KeyError):
        readout_token_count("discrete", {"discrete_token_type": ""},
                            HORIZON, DIM)
    with pytest.raises(ValueError, match="Invalid token_per"):
        ah.DiscreteActionHead(HORIZON, DIM, token_per="per_step")


def discrete_config(config):
    config["base_net_kwargs"]["action_head_type"] = "discrete"
    config["EMA_start_step"] = 0


@pytest.fixture(scope="module")
def pair():
    return build_pair(discrete_config, batch_size=4)


def test_sample_actions_match_jax(pair):
    jmodel, _, model, _, jbatch, batch = pair
    example = jax.tree_util.tree_map(lambda x: np.asarray(x)[:1], jbatch)
    instruction = {"language_instruction":
                   example["task"]["language_instruction"]}
    jbase, jtasks, _ = jmodel.create_tasks(
        instruction_dict=instruction, initial_state=example["initial_state"])
    base, tasks = model.create_tasks(
        instruction_dict=instruction, initial_state=example["initial_state"])
    assert tuple(base["action_head/vocab_proj/kernel"].shape) == (16, 256)
    assert model.base_net.encoder.action_token_num == HORIZON * DIM
    images = example["observation"]["image_primary"]
    ref, _ = jmodel.sample_actions(
        images, instruction, jtasks,
        example["observation"]["timestep_pad_mask"], jbase,
        rng=jax.random.PRNGKey(0))
    got = model.sample_actions(images, instruction, tasks, None, base)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_fp32_discrete_step_matches_jax(pair):
    jmodel, jconfig, model, config, jbatch, batch = pair
    ref_params, ref_ema, ref_info = _jax_step(
        jmodel, jconfig, jbatch, mesh=create_mesh(jax.devices()[:1]))
    old = {k: v.numpy() for k, v in model.params.items()}
    got_params, got_ema, info = _torch_step(model, config, batch)
    assert set(got_params) == set(ref_params)
    assert set(info) == set(ref_info)
    assert {"loss", "mse", "accuracy"} <= set(info)
    for key in ("training_loss", "grad_norm"):
        np.testing.assert_allclose(info[key], ref_info[key], rtol=1e-5,
                                   err_msg=key)
    for key in set(info) - {"training_loss", "grad_norm"}:
        np.testing.assert_allclose(info[key], ref_info[key], rtol=1e-4,
                                   err_msg=key)
    updates = {name: (got_params[name] - old[name],
                      np.asarray(ref) - old[name])
               for name, ref in ref_params.items()}
    typical = np.median([np.linalg.norm(r) for _, r in updates.values()])
    for name, (got, ref) in updates.items():
        if DEGENERATE.search(name):
            assert max(np.linalg.norm(got),
                       np.linalg.norm(ref)) < 0.1 * typical, name
        elif np.linalg.norm(ref) < 1e-3 * typical:
            assert np.linalg.norm(got) < 1e-2 * typical, name
        else:
            assert _cosine(got, ref) > 0.999, name
        np.testing.assert_allclose(got_ema[name], np.asarray(ref_ema[name]),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    flat = flatten_tree(jax.device_get(jmodel.params))
    assert "output_head_action_head_vocab_proj_kernel/kernel" in flat
