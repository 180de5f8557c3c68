"""The train step's two extra weight-decay terms (hypervla_tpu_torch/train/
train_step.py) against the JAX package's make_train_step, one step each
from the same params and batch on the tiny flagship twin (fp32, the JAX
step on a mesh of one CPU device), both optimizers at update count 1000:

  * delta-decay toward pretrained params (here): a partial DINOv2 tree in
    the JAX nesting (the CLS token and one layer's fc1 kernel);
  * the v4 weight decay (tests/test_torch_v4_weight_decay.py, which
    imports the helpers below): the clipped gradient of 0.5 *
    sum(kernel ** 2) over the generated base-net params, times lr *
    auxiliary_loss base_weight_decay; its logged norm to 1e-5.

Each term is isolated in both packages as the JAX package's own test does
(tests/test_train_step_numerics.py): the step with it minus the same step
without it, which must agree between the packages to 1e-5 relative plus
two ulps of the param (the rounding of the sums p + u and p + u + term).
The full steps agree as tests/test_torch_train_step.py holds one step
(loss and grad_norm to 1e-5, each update at cosine > 0.999)."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hypervla_tpu.flagship import build_flagship as jax_build
from hypervla_tpu.flagship import make_flagship_batch as jax_batch
from hypervla_tpu.parallel.mesh import create_mesh, replicated, shard_batch
from hypervla_tpu.train import optimizer as jopt
from hypervla_tpu.train.train_state import TrainState as JaxTrainState
from hypervla_tpu.train.train_step import make_train_step as jax_make_step
from hypervla_tpu_torch.flagship import build_flagship, make_flagship_batch
from hypervla_tpu_torch.train import optimizer as topt
from hypervla_tpu_torch.train.train_state import TrainState
from hypervla_tpu_torch.train.train_step import make_train_step
from hypervla_tpu_torch.utils.convert import flatten_tree, from_jax_params
from test_torch_harness import torch_threads  # noqa: F401

STEP0 = 1000
BATCH = dict(batch_size=8, instr_len=8, action_horizon=2,
             initial_patch_dim=32)
CLS = "encoder_image_encoder_embeddings_cls_token"
FC1 = "encoder_image_encoder_encoder_layer_1_mlp_fc1_kernel"


@pytest.fixture(scope="module")
def models():
    jmodel, _ = jax_build(tiny=True, training=True)
    model, _ = build_flagship(tiny=True, training=True, encoder_dtype=None,
                              device="cpu")
    model.params = from_jax_params(jmodel.params)
    return jmodel, model


def _with_count(opt_state, count):
    return jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(count, x.dtype)
        if getattr(path[-1], "name", None) == "count" else x, opt_state)


def _jax_step(jmodel, opt_config, step_config, pretrained=None):
    """One JAX step whose optimizer is built from opt_config and whose
    make_train_step reads step_config; (params, info)."""
    tx, lr_fn, base_lr_fn, pnorm_fn = jopt.create_optimizer(
        jmodel.params, jopt.hn_param_type_tree(jmodel.params),
        **opt_config["optimizer"])
    mesh = create_mesh(jax.devices()[:1])
    step_fn = jax_make_step(jmodel, step_config, tx, lr_fn, base_lr_fn,
                            pnorm_fn, mesh=mesh, donate=False,
                            pretrained_params=pretrained)
    state = JaxTrainState.create(jax.random.PRNGKey(0), jmodel.params, tx,
                                 track_ema=False)
    state = state.replace(step=jnp.asarray(STEP0),
                          opt_state=_with_count(state.opt_state, STEP0))
    state = jax.device_put(state, replicated(mesh))
    batch = shard_batch(jax_batch(**BATCH), mesh)
    new, info = step_fn(state, batch)
    return ({k: np.asarray(v) for k, v in flatten_tree(
        jax.device_get(new.params)).items()},
        {k: float(v) for k, v in info.items()})


def _torch_step(model, opt_config, step_config, pretrained=None):
    tx, lr_fn, base_lr_fn, pnorm_fn = topt.create_optimizer(
        model.params, topt.hn_param_type_tree(model.params),
        **opt_config["optimizer"])
    step_fn = make_train_step(model, step_config, tx, lr_fn, base_lr_fn,
                              pnorm_fn, pretrained_params=pretrained)
    state = TrainState.create(model.params, tx)
    state.step = STEP0
    state.opt_state["count"] = STEP0
    new, info = step_fn(state, make_flagship_batch(**BATCH))
    return ({k: v.detach().numpy() for k, v in new.params.items()},
            {k: float(v) for k, v in info.items()})


def _cosine(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    n = np.linalg.norm(a) * np.linalg.norm(b)
    return 1.0 if n == 0 and np.allclose(a, b) else float(a @ b / n)


def _assert_steps_agree(old, got, ref, got_info, ref_info):
    """One step of each package as tests/test_torch_train_step.py holds
    it: loss and grad_norm to 1e-5, the update per leaf at cosine > 0.999
    (a leaf the reference barely moves, the port must barely move)."""
    for key in ("training_loss", "grad_norm"):
        np.testing.assert_allclose(got_info[key], ref_info[key], rtol=1e-5,
                                   err_msg=key)
    updates = {k: (got[k] - old[k], ref[k] - old[k]) for k in ref}
    typical = np.median([np.linalg.norm(r) for _, r in updates.values()])
    for name, (g, r) in updates.items():
        if np.linalg.norm(r) < 1e-3 * typical:
            assert np.linalg.norm(g) < 1e-2 * typical, name
        else:
            assert _cosine(g, r) > 0.999, name


def _assert_terms_agree(got_with, got_without, ref_with, ref_without):
    """(with - without) in the port against the same in JAX, per leaf:
    1e-5 relative plus two ulps of the param, and 1e-6 of the largest term
    in the tree (where the term is 0, as on a leaf v4's kernels do not
    reach, the JAX step leaves rounding noise of ~1e-11). Returns how many
    leaves the term moves by more than 1e3 ulps."""
    terms = {name: (got_with[name].astype(np.float64) - got_without[name],
                    ref_with[name].astype(np.float64) - ref_without[name])
             for name in ref_with}
    largest = max(np.abs(ref).max() for _, ref in terms.values())
    moved = 0
    for name, (got, ref) in terms.items():
        ulps = 2 * np.spacing(np.maximum(np.abs(ref_with[name]),
                                         np.abs(ref_without[name])))
        bound = 1e-5 * np.abs(ref) + ulps + 1e-6 * largest
        assert (np.abs(got - ref) <= bound).all(), name
        moved += bool(np.abs(ref).max() > 1e3 * ulps.max())
    return moved


def test_delta_decay_matches_jax(models):
    jmodel, model = models
    config = copy.deepcopy(jmodel.config)
    config["base_net_kwargs"]["vit_kwargs"][
        "fine_tune_pretrained_image_encoder"] = True
    config["optimizer"]["base_weight_decay"] = 0.25
    rng = np.random.default_rng(0)
    # large pretrained values, so that each term stands well above the
    # rounding of the param it is added to
    pretrained = {
        "embeddings": {"cls_token": (rng.standard_normal(
            model.params[CLS].shape) * 100).astype(np.float32)},
        "encoder": {"layer": {"1": {"mlp": {"fc1": {"kernel": (
            rng.standard_normal(model.plan.param_shape[
                "encoder/image_encoder/encoder/layer/1/mlp/fc1/kernel"])
            * 100).astype(np.float32)}}}}},
    }
    old = {k: v.numpy() for k, v in model.params.items()}
    ref, ref_info = _jax_step(jmodel, config, config,
                              jax.tree_util.tree_map(jnp.asarray,
                                                     pretrained))
    ref_plain, _ = _jax_step(jmodel, config, config)
    got, got_info = _torch_step(model, config, config, pretrained)
    got_plain, _ = _torch_step(model, config, config)
    _assert_steps_agree(old, got, ref, got_info, ref_info)
    assert _assert_terms_agree(got, got_plain, ref, ref_plain) == 2
    coef = np.float32(0.25) * np.float32(
        topt.create_lr_schedule(**config["optimizer"][
            "base_learning_rate"])(STEP0))
    np.testing.assert_allclose(
        got[CLS] - got_plain[CLS], coef * pretrained["embeddings"][
            "cls_token"].ravel(), rtol=2e-4, atol=1e-6)
    for name in set(ref) - {CLS, FC1}:
        assert np.array_equal(got[name], got_plain[name]), name


def test_delta_decay_needs_a_pretrained_block(models):
    """A plan without a pretrained image encoder refuses pretrained_params,
    as the JAX step does."""
    _, model = models
    plan = copy.copy(model.plan)
    plan.pretrained_block_path = None
    bare = model.replace(plan=plan)
    config = copy.deepcopy(model.config)
    tx, lr_fn, base_lr_fn, pnorm_fn = topt.create_optimizer(
        model.params, topt.hn_param_type_tree(model.params),
        **config["optimizer"])
    with pytest.raises(ValueError, match="no pretrained image-encoder"):
        make_train_step(bare, config, tx, lr_fn, base_lr_fn, pnorm_fn,
                        pretrained_params={"embeddings": {}})
