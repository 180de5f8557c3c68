"""One fp32 train step of the port with the diffusion head (the score
network's dropout at 0.1) against the JAX package's step on a one-device
mesh, on the tiny DINOv2 twin (tests/test_torch_jax_draws.py::build_pair,
the head at hidden_dim 32 and 2 blocks), the JAX draws replayed: loss and
grad_norm to 1e-5 relative, the other metrics to 1e-4, the update per
leaf at cosine > 0.999 and the EMA to 1e-5, as
tests/test_torch_smallstem_train_step.py holds its step.

The JAX head draws each sample's steps and noise from make_rng("dropout")
inside the step's per-sample vmap, and the score network's dropout inside
its nn.scan. `loss_draws` runs each sample's base-net loss on its own, on
the key the JAX step gives that sample, with jax.random.randint, normal
and bernoulli recorded (the scanned blocks' masks through an ordered
jax.debug.callback, since a value traced inside the scan cannot leave
it), and returns them by the port's sites
(models/action_heads.py::DiffusionActionHead). Also: the step's own draws
repeat under (seed, step), and the trainer's validation MSE matches the
JAX callback's on that callback's per-sample sampler keys."""
import contextlib

import jax
import numpy as np
import pytest
import torch

from hypervla_tpu.parallel.mesh import create_mesh
from hypervla_tpu_torch.models.draws import Draws, draws_generator
from hypervla_tpu_torch.train import optimizer as topt
from hypervla_tpu_torch.train.train_state import TrainState
from hypervla_tpu_torch.train.train_step import make_train_step
from test_torch_harness import torch_threads  # noqa: F401
from test_torch_smallstem_train_step import DEGENERATE
from test_torch_jax_draws import (
    _base_params,
    _sample,
    build_pair,
    dropout_keys,
)
from test_torch_train_step import STEP0, _cosine, _jax_step

BATCH = 4
RATE = 0.1
HEAD = dict(hidden_dim=32, num_blocks=2, diffusion_dropout_rate=RATE)
BLOCKS = "action_head/diffusion_model/trunk/blocks"


def diffusion_config(config):
    config["base_net_kwargs"]["action_head_type"] = "diffusion"
    config["base_net_kwargs"]["action_head_kwargs"].update(HEAD)
    config["EMA_start_step"] = 0


@contextlib.contextmanager
def _recording(records):
    randint, normal = jax.random.randint, jax.random.normal
    bernoulli = jax.random.bernoulli

    def rec_randint(key, shape, minval, maxval, *args, **kwargs):
        out = randint(key, shape, minval, maxval, *args, **kwargs)
        records.append(("time", np.asarray(out)))
        return out

    def rec_normal(key, shape=(), *args, **kwargs):
        out = normal(key, shape, *args, **kwargs)
        records.append(("noise", np.asarray(out)))
        return out

    def rec_bernoulli(key, p=0.5, shape=None, *args, **kwargs):
        out = bernoulli(key, p, shape, *args, **kwargs)
        jax.debug.callback(
            lambda mask: records.append(("dropout", np.asarray(mask))), out,
            ordered=True)
        return out

    jax.random.randint, jax.random.normal = rec_randint, rec_normal
    jax.random.bernoulli = rec_bernoulli
    try:
        yield
    finally:
        jax.random.randint, jax.random.normal = randint, normal
        jax.random.bernoulli = bernoulli


def loss_draws(jmodel, config, batch, keys, num_blocks):
    """{port site: (B, ...) draws} of the JAX step's per-sample losses."""
    per_sample = []
    for i, key in enumerate(keys):
        sample = _sample(batch, i)
        base = _base_params(jmodel, jmodel.params, sample, key, config)
        records = []
        with _recording(records):
            bound = jmodel.base_net.bind({"params": base},
                                         rngs={"dropout": key})
            bound.loss(sample, train=True)
            jax.effects_barrier()
        kinds = [kind for kind, _ in records]
        assert kinds == ["time", "noise"] + ["dropout"] * num_blocks, kinds
        values = [v for _, v in records]
        # (samples, batch 1, window, d) -> (samples, window, d); the masks
        # (samples, 1, window, hidden) -> (samples * window, hidden)
        sites = {"action_head/time": values[0][:, 0],
                 "action_head/noise": values[1][:, 0]}
        for b, mask in enumerate(values[2:]):
            sites[f"{BLOCKS}/{b}/Dropout_0"] = mask.reshape(
                -1, mask.shape[-1])
        per_sample.append(sites)
    return {site: np.stack([s[site] for s in per_sample])
            for site in per_sample[0]}


def _port_step(model, config, batch, draws):
    tx, lr_fn, base_lr_fn, pnorm_fn = topt.create_optimizer(
        model.params, topt.hn_param_type_tree(model.params),
        **config["optimizer"])
    step_fn = make_train_step(model, config, tx, lr_fn, base_lr_fn,
                              pnorm_fn)
    state = TrainState.create(model.params, tx, track_ema=True)
    state.step = STEP0
    state.opt_state["count"] = STEP0
    new, info = step_fn(state, batch, draws=draws)
    return ({k: v.detach().numpy() for k, v in new.params.items()},
            {k: v.numpy() for k, v in new.ema_params.items()},
            {k: float(v) for k, v in info.items()})


@pytest.fixture(scope="module")
def pair():
    return build_pair(diffusion_config, batch_size=BATCH)


def test_fp32_diffusion_step_matches_jax(pair):
    jmodel, jconfig, model, config, jbatch, batch = pair
    ref_params, ref_ema, ref_info = _jax_step(
        jmodel, jconfig, jbatch, mesh=create_mesh(jax.devices()[:1]))
    sites = loss_draws(jmodel, jconfig, jbatch,
                       dropout_keys(jax.random.PRNGKey(0), BATCH),
                       HEAD["num_blocks"])
    assert sites["action_head/time"].shape == (BATCH, 1, 1, 1)
    assert sites["action_head/noise"].shape == (BATCH, 1, 1, 14)
    kept = np.mean([sites[f"{BLOCKS}/{b}/Dropout_0"].mean()
                    for b in range(HEAD["num_blocks"])])
    assert 0.6 < kept < 1.0  # the masks keep ~90%, and drop some

    old = {k: v.numpy() for k, v in model.params.items()}
    got_params, got_ema, info = _port_step(model, config, batch,
                                           Draws(replay=sites))
    assert set(got_params) == set(ref_params)
    assert set(info) == set(ref_info)
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
            # the attention's key biases: an exact gradient of 0, so both
            # steps move them by rounding noise (the smallstem test's rule)
            assert max(np.linalg.norm(got),
                       np.linalg.norm(ref)) < 0.1 * typical, name
        elif np.linalg.norm(ref) < 1e-3 * typical:
            assert np.linalg.norm(got) < 1e-2 * typical, name
        else:
            assert _cosine(got, ref) > 0.999, name
        np.testing.assert_allclose(got_ema[name], np.asarray(ref_ema[name]),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    # the score network's fan-out heads are trained by the step
    assert any(name.startswith("output_head_action_head_diffusion_model")
               and np.linalg.norm(ref) > 1e-3 * typical
               for name, (_, ref) in updates.items())


def test_the_step_repeats_under_its_seed_and_step(pair):
    """Without draws given, the step draws its steps, noise and masks from
    (seed, step): the same state steps to the same params, and records
    each site at its shape."""
    _, _, model, config, _, batch = pair
    tx, lr_fn, base_lr_fn, pnorm_fn = topt.create_optimizer(
        model.params, topt.hn_param_type_tree(model.params),
        **config["optimizer"])
    step_fn = make_train_step(model, config, tx, lr_fn, base_lr_fn,
                              pnorm_fn)
    state = TrainState.create(model.params, tx, seed=3)
    first, _ = step_fn(state, batch)
    again, _ = step_fn(state, batch)
    for name, value in first.params.items():
        assert torch.equal(value, again.params[name]), name
    draws = Draws(draws_generator(3, 0, "cpu"), record=True)
    replayed, _ = step_fn(state, batch, draws=draws)
    for name, value in first.params.items():
        assert torch.equal(value, replayed.params[name]), name
    assert draws.drawn["action_head/time"].shape == (BATCH, 1, 1, 1)
    assert int(draws.drawn["action_head/time"].max()) < 20
    assert draws.drawn[f"{BLOCKS}/1/Dropout_0"].shape == (BATCH, 1, 32)


def test_validation_mse_matches_jax(pair):
    """The trainer's validation MSE on the diffusion head: the JAX
    callback samples each sample's actions from its own key (split from
    PRNGKey(step)); the port's callback, given those keys' sampler draws,
    gives the same MSE, and from its own generator a finite one that
    repeats at a step."""
    from hypervla_tpu.train.callbacks import (
        ValidationCallback as JaxValidation,
    )
    from hypervla_tpu_torch.train.callbacks import ValidationCallback
    from hypervla_tpu_torch.train.train_step import to_tensors
    from test_torch_diffusion_head import sampler_draws

    jmodel, _, model, _, jbatch, batch = pair
    step = 7
    ref = JaxValidation(jmodel, None, {"v": iter([jbatch])}, 1,
                        use_initial_image=True)(jmodel.params, step)
    _, key = jax.random.split(jax.random.PRNGKey(step))
    _, base_net_rng = jax.random.split(key)
    per_sample = [sampler_draws(k, (1, 1, 14))
                  for k in jax.random.split(base_net_rng, BATCH)]
    draws = {site: np.concatenate([d[site] for d in per_sample])
             for site in per_sample[0]}
    callback = ValidationCallback(model, None, {}, 1,
                                  use_initial_image=True)
    got = callback._mse(model.params, to_tensors(batch, "cpu"),
                        Draws(replay=draws))
    np.testing.assert_allclose(got, ref["validation/v/mse"], rtol=1e-5)
    runs = [ValidationCallback(model, None, {"v": iter([batch])}, 1,
                               use_initial_image=True)(model.params, step)
            for _ in range(2)]
    assert runs[0] == runs[1] and np.isfinite(runs[0]["validation/v/mse"])
