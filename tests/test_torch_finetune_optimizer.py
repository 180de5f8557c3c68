"""The port's optimizer options for fine-tuning (hypervla_tpu_torch/train/
optimizer.py) against the JAX package's optax chain, on the tiny flagship
tree with the same random gradients:

  * frozen_keys (`freeze_weights`): the three modes of
    scripts/configs/finetune_config.py over 3 updates, frozen leaves at
    zero with no Adam state, the global-norm clip over the trainable
    leaves only (one case has frozen gradients 1e4 times larger, which a
    clip over every leaf would see), the param norm without the frozen;
  * gradient accumulation (`optax.MultiSteps`) with k = 2 and 3 over 2k
    updates, the clip active on some micro-gradients: zero updates between
    applications, the running mean, the counters;
  * packed AdamW (`_packed_adamw`) against the JAX packed optimizer to
    1e-6 and against the port's per-leaf AdamW bit for bit, with and
    without accumulation; packed + frozen_keys refused in both packages.

Both optimizers start from update count 1000 (optax schedules read the
optimizer's own count), so the LR is not 0."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervla_tpu.flagship import build_flagship as jax_build
from hypervla_tpu.train import optimizer as jopt
from hypervla_tpu_torch.train import optimizer as topt
from hypervla_tpu_torch.utils.convert import flatten_tree, from_jax_params
from scripts.configs.finetune_config import FROZEN_KEYS_BY_MODE
from test_torch_harness import torch_threads  # noqa: F401

COUNT = 1000
OPT = dict(
    learning_rate=dict(name="rsqrt", init_value=0.0, peak_value=3e-4,
                       warmup_steps=2000, timescale=10000),
    base_learning_rate=dict(name="rsqrt", init_value=0.0, peak_value=3e-5,
                            warmup_steps=2000, timescale=10000),
    weight_decay=0.05, base_weight_decay=0.01, weight_decay_strategy="v5",
    clip_gradient=1.0)


@pytest.fixture(scope="module")
def tiny_params():
    model, _ = jax_build(tiny=True, training=True)
    return model.params


def _with_count(opt_state, count):
    return jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(count, x.dtype)
        if getattr(path[-1], "name", None) == "count" else x, opt_state)


def _grads(params, scales, frozen=(), frozen_scale=1.0, seed=0):
    """One tree of standard-normal gradients per scale; leaves named in
    `frozen` (the port's names) times frozen_scale."""
    rng = np.random.default_rng(seed)
    out = []
    for s in scales:
        flat = {}
        for name, p in flatten_tree(params).items():
            scale = s * (frozen_scale if name in frozen else 1.0)
            flat[name] = rng.standard_normal(p.shape).astype(np.float32) * (
                np.float32(scale))
        out.append(flat)
    return out


def _unflat(flat, like):
    """A flat {"a/b": array} dict in the nesting of the JAX tree `like`."""
    return jax.tree_util.tree_map_with_path(
        lambda path, _: jnp.asarray(flat["/".join(str(p.key)
                                                  for p in path)]), like)


def _run_jax(params, grads, opt_cfg, states=False):
    """(updates of each step, the last state or each step's, the param
    norm at the end)."""
    tx, _, _, pnorm = jopt.create_optimizer(
        params, jopt.hn_param_type_tree(params), **opt_cfg)
    state = _with_count(tx.init(params), COUNT)
    out, seen = [], []
    # the compiled update, as the jitted JAX train step runs it
    update = jax.jit(tx.update)
    for g in grads:
        updates, state = update(_unflat(g, params), state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        out.append(flatten_tree(jax.device_get(updates)))
        seen.append(state)
    return out, seen if states else state, float(pnorm(params))


def _set_count(tx, state, count):
    inner = state if tx.k == 1 else state["inner"]
    for s in (inner.values() if isinstance(tx.inner, topt.PackedAdamW)
              else [inner]):
        s["count"] = count


def _run_torch(params, grads, opt_cfg, states=False):
    flat = from_jax_params(params)
    tx, _, _, pnorm = topt.create_optimizer(
        flat, topt.hn_param_type_tree(flat), **opt_cfg)
    state = tx.init(flat)
    _set_count(tx, state, COUNT)
    out, seen = [], []
    for g in grads:
        updates, state = tx.update(
            {k: torch.from_numpy(v) for k, v in g.items()}, state, flat)
        flat = {k: v + updates[k] for k, v in flat.items()}
        out.append(updates)
        seen.append(state)
    return out, seen if states else state, float(pnorm(flat)), tx


def _assert_updates_match(got, ref):
    for step, (g, r) in enumerate(zip(got, ref)):
        assert set(g) == set(r)
        for name, value in r.items():
            np.testing.assert_allclose(g[name].numpy(), np.asarray(value),
                                       rtol=1e-6, atol=1e-12,
                                       err_msg=f"update {step} {name}")


@pytest.mark.parametrize("mode,frozen_scale", [
    ("full", 1.0), ("head_only", 1.0), ("head_mlp_only", 1.0),
    ("head_only", 1e4)])
def test_frozen_keys_match_freeze_weights(tiny_params, mode, frozen_scale):
    keys = FROZEN_KEYS_BY_MODE[mode]
    opt_cfg = dict(OPT, frozen_keys=keys)
    names = list(flatten_tree(tiny_params))
    frozen = topt.frozen_names(dict.fromkeys(names), keys)
    assert bool(frozen) == (mode != "full")
    if mode == "head_only":
        # the trunk, the context encoder, the projections, the position
        # tables and the policy ViT's heads; the action head's trains
        assert all(n.startswith("output_head_action_head_")
                   for n in set(names) - frozen)
    # the first micro-gradient is clipped (norm >> 1), the others not
    grads = _grads(tiny_params, (1.0, 1e-4, 3e-5), frozen, frozen_scale)
    ref, _, ref_pnorm = _run_jax(tiny_params, grads, opt_cfg)
    got, state, pnorm, _ = _run_torch(tiny_params, grads, opt_cfg)
    _assert_updates_match(got, ref)
    for update in got:
        for name in frozen:
            assert not update[name].any(), name
    assert set(state["mu"]) == set(names) - frozen
    assert state["count"] == COUNT + 3
    np.testing.assert_allclose(pnorm, ref_pnorm, rtol=1e-6)
    if frozen_scale > 1:
        # a clip over every leaf would have scaled the trainable leaves'
        # gradient far below what was applied
        both = _run_torch(tiny_params, grads[:1], dict(OPT))[0][0]
        name = next(n for n in names if n not in frozen)
        assert not torch.allclose(both[name], got[0][name], rtol=1e-3)


def _small_tree(params):
    """The leaves of a few kinds of the tiny tree, nested as there: the
    context encoder's final LayerNorm (generated label, not decayed), the
    action head's output heads (decayed kernels) and the trunk's
    embeddings (shared label)."""
    def keep(name):
        return (name.startswith("context_encoder/encoder_norm/")
                or name.startswith("output_head_action_head_continuous")
                or name.startswith("encoder_image_encoder_embeddings"))

    return jax.tree_util.tree_map(
        np.asarray, {k: v for k, v in params.items()
                     if any(keep(n) for n in flatten_tree({k: v}))})


def _assert_close_to_leaf(got, ref, bound):
    """Each update within `bound` of its leaf's largest reference value."""
    for step, (g, r) in enumerate(zip(got, ref)):
        for name, value in r.items():
            value = np.asarray(value)
            err = np.abs(g[name].numpy() - value).max()
            assert err <= bound * np.abs(value).max(), (step, name, err)


@pytest.mark.parametrize("k", [2, 3])
def test_multisteps_match_optax(tiny_params, k):
    """optax.MultiSteps against the jitted update (XLA compiles its inner
    update, under lax.cond, as the jitted train step does: the bf16 first
    moment's decay product in fp32, as the port takes it), over a few
    leaves of each kind, to 1e-5 of each leaf's largest update."""
    params = _small_tree(tiny_params)
    opt_cfg = dict(OPT, grad_accumulation_steps=k)
    # clipped (norm >> 1) and unclipped micro-gradients in turn
    scales = [1.0 if i % 2 == 0 else 1e-4 for i in range(2 * k)]
    grads = _grads(params, scales, seed=k)
    ref, jstates, _ = _run_jax(params, grads, opt_cfg, states=True)
    got, states, _, _ = _run_torch(params, grads, opt_cfg, states=True)
    _assert_close_to_leaf(got, ref, 1e-5)
    for step, (update, state, jstate) in enumerate(zip(got, states,
                                                       jstates)):
        applied = (step + 1) % k == 0
        assert all(bool(u.any()) == applied for u in update.values()), step
        multi = jstate[1]  # chain(clip, MultiSteps)
        assert state["mini_step"] == int(multi.mini_step) == (step + 1) % k
        assert state["gradient_step"] == int(multi.gradient_step) == (
            (step + 1) // k)
        # the inner count (the LR schedules') moves only when it applies
        assert state["inner"]["count"] == COUNT + (step + 1) // k
        # the running mean of the clipped micro-gradients
        for name, value in flatten_tree(
                jax.device_get(multi.acc_grads)).items():
            value = np.asarray(value)
            np.testing.assert_allclose(state["acc_grads"][name].numpy(),
                                       value, rtol=1e-6, atol=1e-12,
                                       err_msg=f"{step} {name}")


@pytest.mark.parametrize("k", [1, 2])
def test_packed_matches_jax_and_the_per_leaf_adamw(tiny_params, k):
    """Against the JAX packed optimizer over two updates (k = 1: the
    eager reference; test_multisteps_match_optax says why not under
    MultiSteps), and against the port's per-leaf AdamW bit for bit over 2k
    updates."""
    opt_cfg = dict(OPT, grad_accumulation_steps=k, packed=True)
    grads = _grads(tiny_params, [1.0, 1e-4] * k, seed=10 + k)
    got, state, _, tx = _run_torch(tiny_params, grads, opt_cfg)
    inner = state if k == 1 else state["inner"]
    if k == 1:
        ref, jstate, _ = _run_jax(tiny_params, grads, opt_cfg)
        _assert_updates_match(got, ref)
        assert set(inner) == set(jstate[1])
    assert all(s["mu"].dtype == torch.bfloat16 and s["mu"].dim() == 1
               for s in inner.values())
    per_leaf, leaf_state, _, _ = _run_torch(
        tiny_params, grads, dict(opt_cfg, packed=False))
    for a, b in zip(got, per_leaf):
        for name in b:
            assert torch.equal(a[name], b[name]), name
    # the packed moments are the per-leaf ones, concatenated
    leaf_inner = leaf_state if k == 1 else leaf_state["inner"]
    for key, (_, names) in tx.inner.members.items():
        for moment in ("mu", "nu"):
            assert torch.equal(inner[key][moment], torch.cat(
                [leaf_inner[moment][n].reshape(-1) for n in names]))


def test_packed_with_frozen_keys_is_refused(tiny_params):
    flat = from_jax_params(tiny_params)
    opt_cfg = dict(OPT, packed=True, frozen_keys=("*context_encoder*",))
    with pytest.raises(ValueError) as ref:
        jopt.create_optimizer(tiny_params,
                              jopt.hn_param_type_tree(tiny_params),
                              **opt_cfg)
    with pytest.raises(ValueError) as got:
        topt.create_optimizer(flat, topt.hn_param_type_tree(flat), **opt_cfg)
    assert str(got.value) == str(ref.value)
