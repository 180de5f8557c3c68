"""The heads the Octo topology builds, in the port against the JAX
package's on the CPU, fp32, on the same params (the JAX init, perturbed)
and readouts, with the JAX draws replayed, each to 1e-5: the MAP-pooled
MSE and L1 heads, the TokenPerDim head (argmax and sampled, the Gumbel
draws of jax.random.categorical), the U-Net DDPM head (models/unet.py:
its forward, loss and sampler) and the diffusion and continuous heads
that BaseNetwork builds, over a window of 2 with MAP pooling,
embodiment_action_dim and a sample_shape. Losses are the JAX head's over the whole batch
(per_sample=False), their draws recorded from the JAX call.
"""
import contextlib

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervla_tpu.models import action_heads as jah
from hypervla_tpu.models import unet as junet
from hypervla_tpu.models.token_group import TokenGroup as JaxGroup
from hypervla_tpu_torch.models import action_heads as ah
from hypervla_tpu_torch.models import unet
from hypervla_tpu_torch.models.draws import Draws
from hypervla_tpu_torch.models.token_group import TokenGroup
from hypervla_tpu_torch.utils.convert import from_jax_params
from test_torch_harness import torch_threads  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
B, W, N, D = 3, 2, 2, 16
KEY = "readout_action"


def _perturbed(tree, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + rng.standard_normal(np.shape(v))
                   * scale).astype(np.float32), flax.core.unfreeze(tree))


def _readouts(window=W, n=N, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.standard_normal((B, window, n, D)).astype(np.float32)
    mask = np.ones((B, window, n), bool)
    return ({KEY: JaxGroup(jnp.asarray(tokens), jnp.asarray(mask))},
            TokenGroup(torch.tensor(tokens), torch.tensor(mask)))


def _targets(horizon, dim, window=W, seed=2):
    rng = np.random.default_rng(seed)
    actions = rng.uniform(-1.2, 1.2, (B, window, horizon, dim)).astype(
        np.float32)
    ts_mask = np.ones((B, window), bool)
    ts_mask[0, 0] = False
    act_mask = rng.random((B, window, horizon, dim)) > 0.2
    return actions, ts_mask, act_mask


def _pair(jhead, head, window=W, n=N, **init_kw):
    outputs, group = _readouts(window, n)
    init = jax.jit(lambda rng, outputs: jhead.init(rng, outputs,
                                                   train=False, **init_kw))
    variables = _perturbed(init(jax.random.PRNGKey(0), outputs))
    params = {f"action_head/{k}": v
              for k, v in from_jax_params(variables["params"]).items()}
    specs = head.specs(D if not getattr(head, "flatten_tokens", False)
                       else D * n)
    assert set(specs) == set(params), sorted(set(specs) ^ set(params))[:6]
    for name, (shape, _) in specs.items():
        assert tuple(params[name].shape) == tuple(shape), name
    return variables, outputs, params, group


@contextlib.contextmanager
def recording(records):
    """jax.random.bernoulli, randint and normal, each draw appended to
    records as (the function's name, the draw)."""
    saved = {name: getattr(jax.random, name)
             for name in ("bernoulli", "randint", "normal")}

    def recorder(name):
        def draw(*args, **kwargs):
            records.append((name, saved[name](*args, **kwargs)))
            return records[-1][1]
        return draw

    for name in saved:
        setattr(jax.random, name, recorder(name))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(jax.random, name, fn)


def sampler_draws(rng, shape, steps):
    """{port site: draw} of a JAX DDPM sampler on `rng`: x_T from the
    second half of its split, then one normal a step down the chain."""
    rng, key = jax.random.split(rng)
    out = {"action_head/x_T": np.asarray(jax.random.normal(key, shape))}
    for t in range(steps - 1, -1, -1):
        rng, key = jax.random.split(rng)
        out[f"action_head/z/{t}"] = np.asarray(jax.random.normal(key, shape))
    return out


def _batch_loss(jhead, variables, outputs, args, move=None):
    """The JAX head's loss over the batch (train=True) and its draws, as
    the port's sites: the MAP head's MLP dropout, then the steps and the
    noise (batch-leading: the JAX draws' leading n_diffusion_samples axis
    moved behind the batch's where `move`)."""
    kinds = []

    def loss_and_draws(variables, outputs, args):
        records = []
        with recording(records):
            loss, metrics = jhead.apply(
                variables, outputs, *args, train=True, method="loss",
                rngs={"dropout": jax.random.PRNGKey(7)})
        kinds[:] = [kind for kind, _ in records]
        return loss, metrics, [v for _, v in records]

    loss, metrics, values = jax.jit(loss_and_draws)(variables, outputs, args)
    records = list(zip(kinds, values))
    masks = [np.asarray(v) for kind, v in records if kind == "bernoulli"]
    sites = {f"action_head/map_head/MlpBlock_0/Dropout_{i}": m
             for i, m in enumerate(masks)}
    draws = [np.asarray(v) for kind, v in records if kind != "bernoulli"]
    for name, value in zip(("action_head/time", "action_head/noise"),
                           draws[-2:]):
        sites[name] = np.moveaxis(value, 0, 1) if move else value
    return float(loss), {k: float(v) for k, v in metrics.items()}, sites


# ------------------------------ MSE and L1 ------------------------------


@pytest.mark.parametrize("name,loss_type", [("MSEActionHead", "mse"),
                                            ("L1ActionHead", "l1")])
def test_map_continuous_heads_match_jax(name, loss_type):
    kw = dict(readout_key=KEY, action_horizon=2, action_dim=7)
    jhead, head = getattr(jah, name)(**kw), getattr(ah, name)(**kw)
    assert head.use_map and head.loss_type == loss_type
    variables, outputs, params, group = _pair(jhead, head)
    want = jhead.apply(variables, outputs, train=False)
    np.testing.assert_allclose(head(params, group).numpy(),
                               np.asarray(want), **TOL)
    actions, ts_mask, act_mask = _targets(2, 7)
    jloss, jmetrics = jhead.apply(variables, outputs, actions, ts_mask,
                                  act_mask, train=False, method="loss")
    loss, metrics = head.loss(params, group, torch.tensor(actions),
                              torch.tensor(ts_mask), torch.tensor(act_mask),
                              per_sample=False)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    for k, v in jmetrics.items():
        assert abs(float(metrics[k]) - float(v)) <= 1e-5 * abs(float(v)), k
    want = jhead.apply(variables, outputs, train=False, sample_shape=(2,),
                       method="predict_action")
    got = head.predict_action(params, group, sample_shape=(2,))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_continuous_head_by_fields_over_a_window():
    kw = dict(readout_key=KEY, use_map=False, action_horizon=2,
              action_dim=7, max_action=3.0, clip_target=True)
    jhead, head = jah.ContinuousActionHead(**kw), ah.ContinuousActionHead(
        **kw)
    variables, outputs, params, group = _pair(jhead, head)
    actions, ts_mask, act_mask = _targets(2, 7)
    jloss, _ = jhead.apply(variables, outputs, actions, ts_mask, act_mask,
                           train=False, method="loss")
    loss, _ = head.loss(params, group, torch.tensor(actions),
                        torch.tensor(ts_mask), torch.tensor(act_mask),
                        per_sample=False)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    with pytest.raises(TypeError, match="unexpected keyword"):
        ah.ContinuousActionHead(readout_key=KEY, hidden_dims=(8,))


# ------------------------------ TokenPerDim ------------------------------


@pytest.fixture(scope="module")
def per_dim():
    kw = dict(readout_key=KEY, action_horizon=2, action_dim=3,
              vocab_size=8, use_map=True)
    jhead, head = jah.TokenPerDimActionHead(**kw), ah.TokenPerDimActionHead(
        **kw)
    return (jhead, head) + _pair(jhead, head)


def test_token_per_dim_head_matches_jax(per_dim):
    jhead, head, variables, outputs, params, group = per_dim
    want = jhead.apply(variables, outputs, train=False)
    np.testing.assert_allclose(head(params, group).numpy(),
                               np.asarray(want), **TOL)
    actions, ts_mask, act_mask = _targets(2, 3)
    jloss, jmetrics = jhead.apply(variables, outputs, actions, ts_mask,
                                  act_mask, train=False, method="loss")
    loss, metrics = head.loss(params, group, torch.tensor(actions),
                              torch.tensor(ts_mask), torch.tensor(act_mask),
                              per_sample=False)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    for k, v in jmetrics.items():
        assert abs(float(metrics[k]) - float(v)) <= 1e-5 * max(
            abs(float(v)), 1.0), k


@pytest.mark.parametrize("argmax,temperature", [(True, 1.0), (False, 1.0),
                                                (False, 0.5)])
def test_token_per_dim_decodes_as_jax(per_dim, argmax, temperature):
    jhead, head, variables, outputs, params, group = per_dim
    key = jax.random.PRNGKey(3)
    want = jhead.apply(variables, outputs, train=False, rng=key,
                       argmax=argmax, temperature=temperature,
                       sample_shape=(2,), method="predict_action")
    logits = jhead.apply(variables, outputs, train=False)[:, -1]
    gumbel = np.asarray(jax.random.gumbel(key, (2, *logits.shape)))
    got = head.predict_action(
        params, group, Draws(replay={"action_head/gumbel": gumbel}),
        argmax=argmax, temperature=temperature, sample_shape=(2,))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if not argmax:
        with pytest.raises(ValueError, match="argmax=True"):
            head.predict_action(params, group)


# ------------------------------ diffusion heads ------------------------------


def test_diffusion_head_over_a_window_matches_jax():
    """MAP pooling, a window of 2, two diffusion samples a step in the
    loss, embodiment_action_dim and a sample_shape in the sampler."""
    kw = dict(readout_key=KEY, use_map=True, action_horizon=2, action_dim=7,
              hidden_dim=32, num_blocks=2, n_diffusion_samples=2)
    jhead, head = jah.DiffusionActionHead(**kw), ah.DiffusionActionHead(**kw)
    variables, outputs, params, group = _pair(jhead, head)
    actions, ts_mask, act_mask = _targets(2, 7)
    jloss, jmetrics, sites = _batch_loss(
        jhead, variables, outputs, (actions, ts_mask, act_mask), move=True)
    loss, metrics = head.loss(params, group, torch.tensor(actions),
                              torch.tensor(ts_mask), torch.tensor(act_mask),
                              draws=Draws(replay=sites), per_sample=False)
    assert abs(float(loss) - jloss) <= 1e-5 * abs(jloss)
    key = jax.random.PRNGKey(5)
    want = jhead.apply(variables, outputs, rng=key, train=False,
                       embodiment_action_dim=5, sample_shape=(2,),
                       method="predict_action")
    draws = Draws(replay=sampler_draws(key, (2, B, W, 14), 20))
    got = head.predict_action(params, group, draws, embodiment_action_dim=5,
                              sample_shape=(2,))
    assert got.shape == (2, B, 2, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def unet_pair():
    kw = dict(readout_key=KEY, action_dim=4, action_horizon=4, timesteps=5,
              use_map=True)
    jhead, head = jah.UNetDDPMActionHead(**kw), ah.UNetDDPMActionHead(**kw)
    return (jhead, head) + _pair(jhead, head, window=1)


def test_unet_forward_matches_jax(unet_pair):
    jhead, head, variables, outputs, params, group = unet_pair
    rng = np.random.default_rng(4)
    time = rng.integers(0, 5, (B, 1, 1)).astype(np.int32)
    noisy = rng.standard_normal((B, 1, 4, 4)).astype(np.float32)
    want = jax.jit(lambda v, o, t, x: jhead.apply(
        v, o, time=t, noisy_actions=x, train=False))(
            variables, outputs, time, noisy)
    got = head(params, group, torch.tensor(time), torch.tensor(noisy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_unet_loss_and_sampler_match_jax(unet_pair):
    jhead, head, variables, outputs, params, group = unet_pair
    actions, ts_mask, act_mask = _targets(4, 4, window=1)
    # the JAX head's loss takes (action_pad_mask, timestep_pad_mask): the
    # Octo driver hands it (timestep_pad_mask, action_pad_mask), in order
    jloss, _, sites = _batch_loss(jhead, variables, outputs,
                                  (actions, ts_mask, act_mask))
    loss, _ = head.loss(params, group, torch.tensor(actions),
                        torch.tensor(ts_mask), torch.tensor(act_mask),
                        draws=Draws(replay=sites), per_sample=False)
    assert abs(float(loss) - jloss) <= 1e-5 * abs(jloss)
    # the JAX sampler samples one batch row (see predict_action)
    one = {KEY: JaxGroup(outputs[KEY].tokens[:1], outputs[KEY].mask[:1])}
    row = TokenGroup(group.tokens[:1], group.mask[:1])
    sample = jax.jit(lambda v, o, key, e: jhead.apply(
        v, o, rng=key, train=False, embodiment_action_dim=e,
        method="predict_action"), static_argnums=3)
    key = jax.random.PRNGKey(6)
    want = np.asarray(sample(variables, one, key, 3))
    draws = Draws(replay=sampler_draws(key, (1, 1, 4, 4), 5))
    got = head.predict_action(params, row, draws, embodiment_action_dim=3)
    # unclipped, the x0 estimate divides by sqrt(alpha_bar) (1e-2 at the
    # first step): the sample is held to 1e-5 of its largest entry
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    with pytest.raises(TypeError, match="carry input and carry output"):
        sample(variables, outputs, key, 3)
    with pytest.raises(TypeError, match="carry input and carry output"):
        head.predict_action(params, group, Draws(replay=sampler_draws(
            key, (B, 1, 4, 4), 5)), embodiment_action_dim=3)


def test_unet_pieces_match_jax():
    t = np.arange(6, dtype=np.int32).reshape(2, 3, 1)
    np.testing.assert_allclose(
        unet.fourier_time_embedding(torch.tensor(t), 16).numpy(),
        np.asarray(junet.fourier_time_embedding(jnp.asarray(t), 16)), **TOL)
    x = np.linspace(-30, 30, 101, dtype=np.float32)
    np.testing.assert_allclose(unet.mish(torch.tensor(x)).numpy(),
                               np.asarray(junet.mish(jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(
        unet.unet_squaredcos_cap_v2(100).numpy(),
        np.asarray(junet.unet_squaredcos_cap_v2(100)), **TOL)
