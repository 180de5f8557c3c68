"""The random draws of the port's training forward
(hypervla_tpu_torch/models/draws.py), and what the port's regularisation
tests share to hold a training step to the JAX package's with the JAX
draws replayed:

  * `build_pair`: the JAX tiny DINOv2 twin and the port's on the same
    params, from one config change; `with_config`, the same pair under a
    change that changes no param, without another JAX init;
  * `jax_reference`: the JAX step's per-sample loss
    (hypervla_tpu/train/train_step.py::sample_loss_fn: the hypernetwork,
    then the base net bound to the generated params, with each sample's
    dropout key split from the state's as the step splits it, and the aux
    losses) vmapped over the batch and jitted, under jax.value_and_grad as
    the step's `_loss_fn`, with jax.random.bernoulli and normal wrapped to
    return each draw by the flax module that drew it, keyed by the port's
    sites: the loss, the gradients and the generated params that the step
    does not return (test_torch_dropout_step.py holds it to the JAX step's
    own loss and gradient norm);
  * `port_step_grads`: one port train step with given draws, returning
    (info, {param: gradient}).

Also here, without JAX: a Draws generated from (seed, step) repeats bit
for bit, differs at another step, keeps each site's mask at its rate, and
replays what it is given.
"""
import contextlib
import copy

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import module as flax_module

from hypervla_tpu.configs.defaults import (
    disable_unused_attention_capture as jax_disable_capture,
)
from hypervla_tpu.configs.defaults import tiny_test_config as jax_tiny_config
from hypervla_tpu.flagship import make_flagship_batch as jax_batch
from hypervla_tpu.models.hypervla import HyperVLA as JaxHyperVLA
from hypervla_tpu_torch.configs import (
    disable_unused_attention_capture,
    tiny_test_config,
)
from hypervla_tpu_torch.flagship import make_flagship_batch
from hypervla_tpu_torch.models.draws import (
    Draws,
    draws_generator,
    dropout,
)
from hypervla_tpu_torch.models.hypervla import HyperVLA
from hypervla_tpu_torch.train import optimizer as topt
from hypervla_tpu_torch.train.train_state import TrainState
from hypervla_tpu_torch.train.train_step import make_train_step
from hypervla_tpu_torch.utils.convert import (
    drop_unread_params,
    flatten_tree,
    from_jax_params,
    trunk_depth,
)
from test_torch_harness import torch_threads  # noqa: F401

#: the batch of the paired tiny models (the flagship batch's keys)
PAIR_BATCH = dict(instr_len=8, action_horizon=2, initial_patch_dim=32)


def build_pair(change=None, batch_size=4, seed=0, perturb=0.05,
               batch_change=None):
    """The JAX tiny DINOv2 twin and the port's from one config change
    (applied to both packages' tiny_test_config, then the training
    default of no unused attention capture), the port on the JAX init
    with its output-head kernels perturbed (so that the context encoder's
    gradients are not 0), and the two batches.

    Returns (jmodel, jconfig, model, config, jbatch, batch)."""
    jconfig, config = jax_tiny_config("DINOv2"), tiny_test_config()
    for c, disable in ((jconfig, jax_disable_capture),
                       (config, disable_unused_attention_capture)):
        if change is not None:
            change(c)
        disable(c)
    jbatch = jax_batch(batch_size=batch_size, **PAIR_BATCH)
    batch = make_flagship_batch(batch_size=batch_size, **PAIR_BATCH)
    if batch_change is not None:
        batch_change(jbatch)
        batch_change(batch)
    jmodel = JaxHyperVLA.from_config(jconfig, jbatch,
                                     jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def nudge(path, x):
        x = np.asarray(x, np.float32)
        name = "/".join(str(p.key) for p in path)
        if name.startswith("output_head") and name.endswith("kernel"):
            x = x + rng.standard_normal(x.shape).astype(np.float32) * (
                np.float32(perturb))
        return x

    params = jax.tree_util.tree_map_with_path(
        nudge, flax.core.unfreeze(jmodel.params))
    jmodel = jmodel.replace(params=params)
    model = HyperVLA.from_config(config, batch, device="cpu")
    ported = drop_unread_params(
        from_jax_params(params, layers=trunk_depth(config)), config)
    assert set(ported) == set(model.params)
    for name, value in model.params.items():
        assert ported[name].shape == value.shape, name
    model.params = ported
    return jmodel, jconfig, model, config, jbatch, batch


@contextlib.contextmanager
def _recording(records):
    """jax.random.bernoulli and normal, each draw appended to records as
    (the drawing module's scope path, the draw)."""
    bernoulli, normal = jax.random.bernoulli, jax.random.normal

    def where():
        top = flax_module._context.module_stack[-1]
        return tuple(top.scope.path) if top is not None else ()

    def rec_bernoulli(key, p=0.5, shape=None, *args, **kwargs):
        out = bernoulli(key, p, shape, *args, **kwargs)
        records.append((where(), out))
        return out

    def rec_normal(key, shape=(), *args, **kwargs):
        out = normal(key, shape, *args, **kwargs)
        records.append((where(), out))
        return out

    jax.random.bernoulli, jax.random.normal = rec_bernoulli, rec_normal
    try:
        yield
    finally:
        jax.random.bernoulli, jax.random.normal = bernoulli, normal


def _hypernet_sites(records, hk):
    """{port site: draw} of one sample's hypernetwork forward: the
    top-level Dropout_<k> are image_dropout (where it is on) then
    embedding_dropout, final_dropout's calls are its groups in order, the
    rest keep their module path."""
    out, top, final = {}, [], 0
    for path, value in records:
        if len(path) == 1 and path[0].startswith("Dropout_"):
            top.append(value)
        elif path == ("final_dropout",):
            out[f"final_dropout/{final}"] = value
            final += 1
        else:
            out["/".join(path)] = value
    names = []
    if hk.get("use_initial_image") and hk.get("image_dropout", 0.0) > 0:
        names.append("image_dropout")
    if hk.get("embedding_dropout_rate", 0.0) > 0:
        names.append("embedding_dropout")
    assert len(names) == len(top), (names, len(top))
    out.update(zip(names, top))
    return out


def _base_sites(records):
    out = {}
    for path, value in records:
        site = "embedding_noise" if path == ("encoder",) else "/".join(path)
        out[site] = value
    return out


def _sample(batch, i):
    return jax.tree_util.tree_map(lambda x: np.asarray(x)[i:i + 1], batch)


def dropout_keys(state_rng, batch_size):
    """The per-sample dropout keys of the JAX step from its state's key."""
    _, dropout_rng = jax.random.split(state_rng)
    return jax.random.split(dropout_rng, batch_size)


def _base_params(jmodel, params, sample, rng, config):
    hk = config["hypernet_kwargs"]
    initial = sample["initial_state"] if hk.get("use_initial_image") else None
    base, _ = jmodel.hypernet.apply(
        {"params": params}, sample["task"], train=True,
        initial_states=initial, rngs={"dropout": rng},
        broadcast_shared=False)
    flags = jmodel.hypernet.base_net_metadata["generation_flag"]
    return jax.tree_util.tree_map(lambda p, gen: p.squeeze(0) if gen else p,
                                  flax.core.unfreeze(base), flags)


def _base_rngs(config, rng):
    vk = config["base_net_kwargs"]["vit_kwargs"]
    if vk.get("image_embedding_noise", 0.0) > 0.0:
        rng, noise_rng = jax.random.split(rng)
        return {"dropout": rng, "embedding_noise": noise_rng}
    return {"dropout": rng}


def jax_reference(jmodel, config, batch, keys, step=0, grad=True):
    """The JAX step's per-sample loss (hypervla_tpu/train/train_step.py::
    sample_loss_fn, its aux losses included) vmapped over the batch with
    the step's dropout keys, jitted, under jax.value_and_grad (grad) as
    the step's `_loss_fn`; every draw of the forward comes out with it.

    Returns a dict: loss, losses (B,), metrics, generated ({block: (B,
    ...)}), sites ({port site: the draws, (B, ...)}) and with grad, grads
    ({param: gradient})."""
    aux = config["auxiliary_loss"]
    num_steps = config.get("num_steps", 100000)
    paths = {}

    def sample_loss(params, sample, rng):
        sample = jax.tree_util.tree_map(lambda x: x[None], sample)
        hyper, base_draws = [], []
        with _recording(hyper):
            base = _base_params(jmodel, params, sample, rng, config)
        with _recording(base_draws):
            bound = jmodel.base_net.bind({"params": base},
                                         rngs=_base_rngs(config, rng))
            loss, metrics, attention_map = bound.loss(sample, train=True)
        if aux.get("attention_entropy", 0.0) > 0.0:
            prob = attention_map[:, :, -1]
            entropy = jnp.mean(-jnp.sum(prob * jnp.log(prob + 1e-8), -1))
            loss = loss + aux["attention_entropy"] * entropy
            metrics["attention_entropy_loss"] = entropy
        if aux.get("attention_map_alignment", 0.0) > 0.0:
            policy = attention_map[:, :, -1, :-1]
            reference = sample["observation"][
                "DINO_last_layer_attention_map"][:, :, 0, 1:]
            alignment = ((policy.mean(1) - reference.mean(1)) ** 2).mean()
            loss = loss + (1.0 - step / num_steps) * aux[
                "attention_map_alignment"] * alignment
            metrics["attention_alignment_loss"] = alignment
        paths["hyper"] = [p for p, _ in hyper]
        paths["base"] = [p for p, _ in base_draws]
        draws = ([v for _, v in hyper], [v for _, v in base_draws])
        return loss, (metrics, base, draws)

    def total(params):
        losses, (metrics, base, draws) = jax.vmap(
            sample_loss, in_axes=(None, 0, 0))(params, batch, keys)
        return losses.mean(), (losses, metrics, base, draws)

    params = jmodel.params
    out = {}
    if grad:
        fn = jax.jit(jax.value_and_grad(total, has_aux=True))
        (loss, rest), grads = fn(params)
        out["grads"] = flatten_tree(jax.device_get(grads))
    else:
        loss, rest = jax.jit(total)(params)
    losses, metrics, base, (hyper, base_draws) = jax.device_get(rest)
    flags = flatten_tree(jax.device_get(
        jmodel.hypernet.base_net_metadata["generation_flag"]))
    out.update(loss=float(loss), losses=np.asarray(losses),
               metrics=metrics,
               generated={k: np.asarray(v)
                          for k, v in flatten_tree(base).items()
                          if flags[k]})

    def squeeze(values):  # (B, 1, ...) per-sample draws -> (B, ...)
        return [np.asarray(v)[:, 0] for v in values]

    sites = _hypernet_sites(list(zip(paths["hyper"], squeeze(hyper))),
                            config["hypernet_kwargs"])
    sites.update(_base_sites(zip(paths["base"], squeeze(base_draws))))
    out["sites"] = sites
    return out


def with_config(pair, change):
    """A pair on the same params whose config differs by `change` in keys
    that change no param (dropout rates, noise, aux losses): both
    packages' modules rebuilt from the changed config."""
    from hypervla_tpu.models.base_network import BaseNetwork as JaxBaseNet
    from hypervla_tpu.models.hypernetwork import HyperNetwork as JaxHyperNet

    jmodel, jconfig, model, config, jbatch, batch = pair
    jconfig, config = copy.deepcopy(jconfig), copy.deepcopy(config)
    change(jconfig)
    change(config)
    jmodel = jmodel.replace(
        config=jconfig,
        hypernet=JaxHyperNet(jmodel.base_net_metadata,
                             jconfig["hypernet_kwargs"]),
        base_net=JaxBaseNet(**jconfig["base_net_kwargs"],
                            octo_kwargs=jconfig["model"]))
    params = model.params
    model = HyperVLA.from_config(config, batch, device="cpu")
    assert set(model.params) == set(params)
    model.params = params
    return jmodel, jconfig, model, config, jbatch, batch


def port_step_grads(model, config, batch, draws, step=0):
    """(info, {param: gradient}) of one port train step at `step`."""
    tx, lr_fn, base_lr_fn, pnorm_fn = topt.create_optimizer(
        model.params, topt.hn_param_type_tree(model.params),
        **config["optimizer"])
    step_fn = make_train_step(model, config, tx, lr_fn, base_lr_fn, pnorm_fn)
    state = TrainState.create(
        {k: v.clone().requires_grad_(True) for k, v in model.params.items()},
        tx, track_ema=False)
    state.step = step
    _, info = step_fn(state, batch, draws=draws)
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             .numpy() for k, p in state.params.items()}
    return {k: float(v) for k, v in info.items()}, grads


def assert_grads_close(got, ref, rel=1e-5):
    """Each leaf's gradient within rel of the largest gradient of the
    whole tree (a leaf whose gradient is rounding noise, as the key bias's,
    is held at the same bound)."""
    assert set(got) == set(ref)
    scale = max(float(np.abs(np.asarray(v)).max()) for v in ref.values())
    for name, value in ref.items():
        err = float(np.abs(got[name] - np.asarray(value)).max())
        assert err <= rel * scale, (name, err, scale)


# ------------------------------ the Draws ------------------------------


def test_draws_repeat_at_a_step_and_differ_at_another():
    def masks(step):
        draws = Draws(draws_generator(7, step, "cpu"))
        return draws.keep_mask("a", (64, 33), 0.9, "cpu"), draws.normal(
            "b", (5, 7), "cpu")

    a, b = masks(3)
    c, d = masks(3)
    assert torch.equal(a, c) and torch.equal(b, d)
    e, f = masks(4)
    assert not torch.equal(a, e) and not torch.equal(b, f)
    # another seed, another stream
    g = Draws(draws_generator(8, 3, "cpu")).keep_mask("a", (64, 33), 0.9,
                                                      "cpu")
    assert not torch.equal(a, g)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keeps_its_rate_and_scales(rate):
    x = torch.ones(200, 301)
    draws = Draws(draws_generator(0, 0, "cpu"), record=True)
    y = dropout(x, rate, draws, "site")
    mask = draws.drawn["site"]
    n, keep = mask.numel(), 1.0 - rate
    kept = float(mask.float().mean())
    assert abs(kept - keep) <= 4 * (keep * rate / n) ** 0.5
    assert torch.equal(y, torch.where(mask, x / keep, torch.zeros_like(x)))


def test_no_draws_and_rate_zero_are_the_identity():
    x = torch.randn(3, 4)
    assert dropout(x, 0.3, None, "s") is x
    assert dropout(x, 0.0, Draws(draws_generator(0, 0, "cpu")), "s") is x


def test_replay_gives_back_its_draws_and_refuses_a_missing_site():
    mask = np.random.default_rng(0).random((2, 3)) < 0.5
    draws = Draws(replay={"s": mask})
    assert np.array_equal(draws.keep_mask("s", (2, 3), 0.5, "cpu").numpy(),
                          mask)
    with pytest.raises(KeyError, match="t"):
        draws.keep_mask("t", (2, 3), 0.5, "cpu")
    with pytest.raises(ValueError, match="shape"):
        draws.keep_mask("s", (3, 2), 0.5, "cpu")
    with pytest.raises(ValueError):
        Draws()


@pytest.mark.parametrize("rate", [0.1, 0.5, 0.9])
def test_dropout_is_flax_dropout_on_its_mask(rate):
    """flax's nn.Dropout on a key, its mask recorded, and the port's
    dropout on that mask: the output and the input gradient bit-equal."""
    import flax.linen as nn

    x = np.random.default_rng(0).standard_normal((3, 5, 7)).astype(
        np.float32)
    records = []
    with _recording(records):
        drop = nn.Dropout(rate)
        ref, vjp = jax.vjp(lambda v: drop.apply(
            {}, v, deterministic=False,
            rngs={"dropout": jax.random.PRNGKey(1)}), jnp.asarray(x))
        (ref_grad,) = vjp(jnp.ones_like(ref))
    (_, mask), = records
    xt = torch.tensor(x, requires_grad=True)
    got = dropout(xt, rate, Draws(replay={"s": np.asarray(mask)}), "s")
    got.sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(ref_grad))


@pytest.mark.parametrize("aux", ["entropy", "alignment", "both"])
def test_aux_losses_are_the_jax_step_formulas(aux):
    """train_step.py::aux_losses on random maps against the JAX step's
    formulas (hypervla_tpu/train/train_step.py:166-190) in numpy, per
    sample, at step 250 of 1000."""
    from hypervla_tpu_torch.train.train_step import REFERENCE_MAP, aux_losses

    rng = np.random.default_rng(2)
    probs = rng.random((3, 2, 9, 9)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    reference = rng.random((3, 4, 1, 9)).astype(np.float32)
    coef = {"entropy": (0.1, 0.0), "alignment": (0.0, 0.2),
            "both": (0.1, 0.2)}[aux]
    config = {"num_steps": 1000, "auxiliary_loss": {
        "attention_entropy": coef[0], "attention_map_alignment": coef[1]}}
    base = rng.random(3).astype(np.float32)
    got, metrics = aux_losses(
        config, torch.tensor(base), {"policy": [torch.tensor(probs)]},
        {"observation": {REFERENCE_MAP: torch.tensor(reference)}}, 250)
    want = base.astype(np.float64)
    last = probs[:, :, -1].astype(np.float64)
    entropy = (-(last * np.log(last + 1e-8)).sum(-1)).mean(-1)
    alignment = ((probs[:, :, -1, :-1].mean(1)
                  - reference[:, :, 0, 1:].mean(1)) ** 2).mean(-1)
    want = want + coef[0] * entropy + 0.75 * coef[1] * alignment
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert set(metrics) == ({"attention_entropy_loss"} if coef[0] else set()
                            ) | ({"attention_alignment_loss"} if coef[1]
                                 else set())
