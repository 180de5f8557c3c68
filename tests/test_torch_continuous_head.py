"""The port's regression action heads (hypervla_tpu_torch/models/
action_heads.py) against the JAX package's (hypervla_tpu/models/
action_heads.py) on the CPU, fp32 to 1e-5, with the same params and
readout tokens from a numpy seed: ContinuousActionHead's forward, decode
and loss (mse and l1, clip_target, squash on and off), and the mix head's
hidden_dims and token_per_horizon. The JAX heads average their loss over
the batch they are given; the port's returns one loss per sample, as the
JAX train step takes it inside its per-sample vmap, so each sample's loss
is held to the JAX head's on that sample alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervla_tpu.models import action_heads as jah
from hypervla_tpu.models.token_group import TokenGroup
from hypervla_tpu_torch.models import action_heads as ah
from hypervla_tpu_torch.models.base_network import readout_token_count
from hypervla_tpu_torch.utils.convert import from_jax_params
from test_torch_harness import torch_threads  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
HORIZON, DIM, EMB, BATCH, WINDOW = 3, 7, 16, 4, 2


def _inputs(tokens, seed=0):
    rng = np.random.RandomState(seed)
    emb = rng.randn(BATCH, WINDOW, tokens, EMB).astype(np.float32)
    actions = (rng.randn(BATCH, WINDOW, HORIZON, DIM) * 4).astype(np.float32)
    actions[..., -1] = rng.randint(0, 2, (BATCH, WINDOW, HORIZON))
    pad = rng.rand(BATCH, WINDOW) > 0.3
    pad[:, -1] = True
    action_pad = rng.rand(BATCH, WINDOW, HORIZON, DIM) > 0.2
    return emb, actions, pad, action_pad


def _perturbed(variables, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda v: (v + rng.randn(*v.shape) * 0.3).astype(np.float32),
        variables)


def _pair(jax_head, port_head, tokens):
    """(jax variables, port params) of the two heads on the same values."""
    emb, *_ = _inputs(tokens)
    variables = _perturbed(jax_head.init(
        jax.random.PRNGKey(0), {"readout_action": TokenGroup(emb, None)},
        train=False), 1)
    params = {f"action_head/{k}": v for k, v in from_jax_params(
        jax.tree_util.tree_map(np.asarray, variables["params"])).items()}
    specs = port_head.specs(EMB)
    assert set(params) == set(specs)
    for name, (shape, _) in specs.items():
        assert tuple(params[name].shape) == tuple(shape), name
    return variables, params


def _check(jax_head, port_head, tokens, outputs):
    variables, params = _pair(jax_head, port_head, tokens)
    emb, actions, pad, action_pad = _inputs(tokens)
    group = {"readout_action": TokenGroup(emb, None)}
    ref = jax_head.apply(variables, group, train=False)
    got = port_head(params, torch.tensor(emb))
    ref, got = (ref, got) if outputs == 2 else ((ref,), (got,))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    np.testing.assert_allclose(
        port_head.predict_action(params, torch.tensor(emb)).numpy(),
        np.asarray(jax_head.apply(variables, group, train=False,
                                  method="predict_action")), **TOL)
    losses, metrics = port_head.loss(
        params, torch.tensor(emb), torch.tensor(actions), torch.tensor(pad),
        torch.tensor(action_pad))
    assert losses.shape == (BATCH,)
    for i in range(BATCH):
        sample = {"readout_action": TokenGroup(emb[i:i + 1], None)}
        loss, ref_metrics = jax_head.apply(
            variables, sample, actions[i:i + 1], pad[i:i + 1],
            action_pad[i:i + 1], train=False, method="loss")
        np.testing.assert_allclose(float(losses[i]), float(loss), **TOL)
        assert set(metrics) == set(ref_metrics)
        for key, value in ref_metrics.items():
            np.testing.assert_allclose(float(metrics[key][i]), float(value),
                                       err_msg=key, **TOL)


def _kwargs(**changes):
    kw = dict(max_action=5.0, tanh_scaling_factor=5.0,
              squash_continuous_action=True, clip_target=False,
              loss_type="mse", token_per_horizon=False)
    kw.update(changes)
    return kw


@pytest.mark.parametrize("changes", [
    {},
    dict(loss_type="l1"),
    dict(clip_target=True, max_action=2.0),
    dict(squash_continuous_action=False),
    dict(squash_continuous_action=False, loss_type="l1", clip_target=True,
         max_action=3.0),
    dict(tanh_scaling_factor=2.0),
])
def test_continuous_head_matches_jax(changes):
    kw = _kwargs(**changes)
    jax_head = jah.ContinuousActionHead(
        readout_key="readout_action", action_horizon=HORIZON,
        action_dim=DIM, **kw)
    _check(jax_head, ah.ContinuousActionHead(HORIZON, DIM, kw), 1, 1)


def test_continuous_head_mean_pools_several_tokens():
    """The continuous head reads the mean of its readout tokens (a window
    of token_per_horizon tokens)."""
    kw = _kwargs(token_per_horizon=True)
    jax_head = jah.ContinuousActionHead(
        readout_key="readout_action", action_horizon=HORIZON,
        action_dim=DIM, **kw)
    _check(jax_head, ah.ContinuousActionHead(HORIZON, DIM, kw), HORIZON, 1)


@pytest.mark.parametrize("hidden_dims,per_horizon", [
    ((), True), ((24,), False), ((24, 8), False), ((12,), True)])
def test_mix_head_options_match_jax(hidden_dims, per_horizon):
    kw = _kwargs(token_per_horizon=per_horizon, hidden_dims=hidden_dims,
                 clip_target=True)
    del kw["loss_type"]
    jax_head = jah.MixActionHead(
        readout_key="readout_action", action_horizon=HORIZON,
        action_dim=DIM, **kw)
    tokens = readout_token_count("mix", kw, HORIZON, DIM)
    assert tokens == (HORIZON if per_horizon else 1)
    _check(jax_head, ah.MixActionHead(HORIZON, DIM, kw), tokens, 2)


def test_mix_head_with_per_sample_params_matches_each_sample():
    """Generated head params with a leading sample axis (the training
    step's per_sample_view: kernels (B, in, out), biases and norms
    (B, 1, dim)) over token_per_horizon tokens: sample i's outputs are the
    head's on sample i's own params."""
    kw = _kwargs(token_per_horizon=True, hidden_dims=(12,))
    head = ah.MixActionHead(HORIZON, DIM, kw)
    gen = torch.Generator().manual_seed(0)
    per_sample = [{k: torch.randn(shape, generator=gen)
                   for k, (shape, _) in head.specs(EMB).items()}
                  for _ in range(BATCH)]
    stacked = {k: torch.stack([p[k] for p in per_sample])
               for k in per_sample[0]}
    stacked = {k: v if k.endswith("/kernel") else v[:, None]
               for k, v in stacked.items()}
    emb = torch.tensor(_inputs(HORIZON)[0])
    arm, grip = head(stacked, emb)
    for i in range(BATCH):
        a, g = head(per_sample[i], emb[i:i + 1])
        torch.testing.assert_close(arm[i:i + 1], a, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(grip[i:i + 1], g, rtol=1e-5, atol=1e-5)


def test_continuous_loss_refuses_an_unknown_type():
    with pytest.raises(ValueError, match="Invalid loss type"):
        ah.continuous_loss(torch.zeros(1, 2), torch.zeros(1, 2),
                           torch.ones(1, 2, dtype=torch.bool), "huber")
    with pytest.raises(ValueError, match="Invalid loss type"):
        jah.continuous_loss(jnp.zeros((1, 2)), jnp.zeros((1, 2)),
                            jnp.ones((1, 2), bool), "huber")


def test_map_pooling_is_refused_naming_its_item():
    """use_map in action_head_kwargs reaches the JAX ContinuousActionHead
    twice (the JAX BaseNetwork passes use_map=False itself): a TypeError
    naming it, in both packages."""
    with pytest.raises(TypeError, match="use_map"):
        ah.ContinuousActionHead(HORIZON, DIM, _kwargs(use_map=True))
    with pytest.raises(TypeError, match="use_map"):
        jah.ContinuousActionHead(readout_key="readout_action",
                                 use_map=False, **_kwargs(use_map=True))


@pytest.mark.parametrize("head", ["mix", "continuous", "diffusion",
                                  "discrete"])
def test_use_map_in_action_head_kwargs_is_taken_as_jax_takes_it(head):
    """HyperVLA.from_config in both packages on the tiny SmallStem config
    with use_map=True in action_head_kwargs: the continuous head raises
    TypeError (use_map reaches it twice), the heads that the JAX
    BaseNetwork builds from named keys ignore it, and both packages build
    the same param tree as without it."""
    from hypervla_tpu.configs import tiny_test_config as jax_tiny_config
    from hypervla_tpu.flagship import make_flagship_batch as jax_batch
    from hypervla_tpu.models.hypervla import HyperVLA as JaxHyperVLA
    from hypervla_tpu_torch.configs import tiny_test_config
    from hypervla_tpu_torch.flagship import make_flagship_batch
    from hypervla_tpu_torch.models.hypervla import HyperVLA
    from hypervla_tpu_torch.utils.convert import flatten_tree

    jconfig = jax_tiny_config("SmallStem", action_head_type=head)
    config = tiny_test_config("SmallStem", action_head_type=head)
    for c in (jconfig, config):
        kw = c["base_net_kwargs"]["action_head_kwargs"]
        if head == "continuous":  # the JAX head's own keys (see above)
            kw = {k: v for k, v in kw.items() if k in _kwargs()}
        c["base_net_kwargs"]["action_head_kwargs"] = dict(kw, use_map=True)
    shapes = dict(instr_len=8, action_horizon=2, image_size=64,
                  initial_patch_dim=32)
    if head == "continuous":
        with pytest.raises(TypeError, match="use_map"):
            JaxHyperVLA.from_config(jconfig, jax_batch(**shapes),
                                    jax.random.PRNGKey(0))
        with pytest.raises(TypeError, match="use_map"):
            HyperVLA.from_config(config, make_flagship_batch(**shapes),
                                 device="cpu")
        return
    jmodel = JaxHyperVLA.from_config(jconfig, jax_batch(**shapes),
                                     jax.random.PRNGKey(0))
    model = HyperVLA.from_config(config, make_flagship_batch(**shapes),
                                 device="cpu")
    ref = flatten_tree(jax.device_get(jmodel.params))
    assert {k: tuple(v.shape) for k, v in model.params.items()} == {
        k: tuple(np.shape(v)) for k, v in ref.items()}
    del config["base_net_kwargs"]["action_head_kwargs"]["use_map"]
    without = HyperVLA.from_config(config, make_flagship_batch(**shapes),
                                   device="cpu")
    assert {k: v.shape for k, v in without.params.items()} == {
        k: v.shape for k, v in model.params.items()}


def test_the_continuous_head_takes_the_configs_keys_but_no_hidden_layers():
    """The port's head builds from the pretrain config's whole
    action_head_kwargs (the JAX head raises on its other heads' keys) and
    refuses hidden_dims, which are the mix head's."""
    from hypervla_tpu_torch.configs import pretrain_config

    kw = pretrain_config()["base_net_kwargs"]["action_head_kwargs"]
    head = ah.ContinuousActionHead(HORIZON, DIM, kw)
    assert head.loss_type == "mse" and head.squash
    with pytest.raises(TypeError):
        jah.ContinuousActionHead(readout_key="readout_action", **kw)
    with pytest.raises(ValueError, match="hidden_dims"):
        ah.ContinuousActionHead(HORIZON, DIM, dict(kw, hidden_dims=(8,)))
