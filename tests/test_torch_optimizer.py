"""The port's optimizer (hypervla_tpu_torch/train/optimizer.py) against the
JAX package's optax one: the LR schedules, the weight-decay masks and the
generated/shared labels on the tiny flagship tree, and two AdamW updates
(global-norm clipping, the generated/shared split, the bf16 first moment)
on the same params and grads."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervla_tpu.flagship import build_flagship as jax_build
from hypervla_tpu.train import optimizer as jopt
from hypervla_tpu_torch.train import optimizer as topt
from hypervla_tpu_torch.utils.convert import flatten_tree, from_jax_params
from test_torch_harness import torch_threads  # noqa: F401

STEPS = (0, 1, 1999, 2000, 2500, 50000)
SCHEDULES = {
    "rsqrt": dict(name="rsqrt", init_value=0.0, peak_value=3e-4,
                  warmup_steps=2000, timescale=10000),
    "cosine": dict(name="cosine", init_value=1e-5, peak_value=3e-4,
                   warmup_steps=2000, decay_steps=60000, end_value=1e-6),
    "constant": dict(name="constant", init_value=0.0, peak_value=3e-4,
                     warmup_steps=2000),
}


@pytest.mark.parametrize("kind", sorted(SCHEDULES))
def test_lr_schedules_match_optax(kind):
    kw = dict(SCHEDULES[kind])
    ref = jopt.create_lr_schedule(**kw)
    got = topt.create_lr_schedule(**kw)
    for step in STEPS:
        want = float(ref(jnp.asarray(step, jnp.int32)))
        np.testing.assert_allclose(got(step), want, rtol=1e-7, atol=0,
                                   err_msg=f"{kind} step {step}")


@pytest.fixture(scope="module")
def tiny_params():
    model, _ = jax_build(tiny=True, training=True)
    return model.params


@pytest.mark.parametrize("strategy", ["v1", "v2", "v3", "v5"])
def test_decay_masks_and_labels_match_jax(tiny_params, strategy):
    flat = from_jax_params(tiny_params)
    ref_mask = flatten_tree(jopt._wd_mask(strategy, tiny_params))
    assert topt.wd_mask(strategy, flat) == {k: bool(v)
                                            for k, v in ref_mask.items()}
    ref_labels = flatten_tree(jopt.hn_param_type_tree(tiny_params))
    assert topt.hn_param_type_tree(flat) == ref_labels
    assert set(ref_labels.values()) == {"generated", "shared"}


def _with_count(opt_state, count):
    return jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(count, x.dtype)
        if getattr(path[-1], "name", None) == "count" else x, opt_state)


def test_two_adamw_updates_match_optax(tiny_params):
    opt_cfg = dict(
        learning_rate=SCHEDULES["rsqrt"],
        base_learning_rate=dict(SCHEDULES["rsqrt"], peak_value=3e-5),
        weight_decay=0.05, base_weight_decay=0.01,
        weight_decay_strategy="v5", clip_gradient=1.0,
        frozen_keys=(), grad_accumulation_steps=1)
    rng = np.random.default_rng(0)
    # the first gradient is clipped (global norm >> 1), the second is not
    grads = [jax.tree_util.tree_map(
        lambda p, s=s: jnp.asarray(rng.standard_normal(p.shape) * s,
                                   jnp.float32), tiny_params)
             for s in (1.0, 1e-4)]

    tx, *_ = jopt.create_optimizer(
        tiny_params, jopt.hn_param_type_tree(tiny_params), **opt_cfg)
    state = _with_count(tx.init(tiny_params), 2500)
    params = tiny_params
    ref_updates = []
    # the compiled update, as the jitted JAX train step runs it
    update = jax.jit(tx.update)
    for g in grads:
        updates, state = update(g, state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        ref_updates.append(flatten_tree(jax.device_get(updates)))

    flat = from_jax_params(tiny_params)
    ttx, _, _, _ = topt.create_optimizer(
        flat, topt.hn_param_type_tree(flat), **opt_cfg)
    tstate = ttx.init(flat)
    tstate["count"] = 2500
    tparams = flat
    for g, ref in zip(grads, ref_updates):
        updates, tstate = ttx.update(from_jax_params(g), tstate, tparams)
        tparams = {k: v + updates[k] for k, v in tparams.items()}
        assert set(updates) == set(ref)
        for name, value in ref.items():
            np.testing.assert_allclose(updates[name].numpy(),
                                       np.asarray(value), rtol=1e-6,
                                       atol=1e-12, err_msg=name)
    assert tstate["count"] == 2502
    assert all(m.dtype == torch.bfloat16 for m in tstate["mu"].values())



def _mu_leaves(opt_state):
    """{port param name: bf16 first moment} of a JAX optimizer state: the
    `mu` trees of every scale_by_adam state in it."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(opt_state)[0]:
        names = [getattr(p, "name", None) for p in path]
        if "mu" not in names:
            continue
        keys = [str(p.key) for p in path[names.index("mu") + 1:]
                if hasattr(p, "key")]
        out["/".join(keys)] = np.asarray(leaf)
    return out


def test_adamw_first_moment_matches_jitted_optax_bit_for_bit(tiny_params):
    """Three updates of the per-leaf AdamW against jax.jit of the JAX
    package's optimizer update (the compiled step's rounding: the product
    of the bf16 b1 and the stored bf16 moment taken in fp32, the sum
    rounded to bf16 once): the bf16 first moments bit-equal after every
    update, the updates to 1e-6."""
    opt_cfg = dict(
        learning_rate=SCHEDULES["rsqrt"],
        base_learning_rate=dict(SCHEDULES["rsqrt"], peak_value=3e-5),
        weight_decay=0.05, base_weight_decay=0.01,
        weight_decay_strategy="v5", clip_gradient=1.0,
        frozen_keys=(), grad_accumulation_steps=1)
    rng = np.random.default_rng(1)
    grads = [jax.tree_util.tree_map(
        lambda p, s=s: jnp.asarray(rng.standard_normal(p.shape) * s,
                                   jnp.float32), tiny_params)
             for s in (1e-4, 3e-5, 1e-4)]
    tx, *_ = jopt.create_optimizer(
        tiny_params, jopt.hn_param_type_tree(tiny_params), **opt_cfg)
    state = _with_count(tx.init(tiny_params), 2500)
    update = jax.jit(tx.update)
    flat = from_jax_params(tiny_params)
    ttx, _, _, _ = topt.create_optimizer(
        flat, topt.hn_param_type_tree(flat), **opt_cfg)
    tstate = ttx.init(flat)
    tstate["count"] = 2500
    params, tparams = tiny_params, flat
    for step, g in enumerate(grads):
        updates, state = update(g, state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        tupdates, tstate = ttx.update(from_jax_params(g), tstate, tparams)
        tparams = {k: v + tupdates[k] for k, v in tparams.items()}
        mu = _mu_leaves(state)
        assert set(mu) == set(tstate["mu"])
        for name, value in mu.items():
            np.testing.assert_array_equal(
                tstate["mu"][name].float().numpy(),
                value.astype(np.float32), err_msg=f"{step} {name}")
        for name, value in flatten_tree(jax.device_get(updates)).items():
            np.testing.assert_allclose(tupdates[name].numpy(),
                                       np.asarray(value), rtol=1e-6,
                                       atol=1e-12, err_msg=f"{step} {name}")
