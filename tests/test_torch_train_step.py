"""One step of the port's train step (hypervla_tpu_torch/train/) against
the JAX package's, from the same params and the same batch, on the tiny
flagship twin on the CPU:

  (a) the fp32 trunk with metrics: loss and grad_norm to 1e-5 rel, the
      update per leaf at cosine > 0.999 (Adam's first step is near
      sign(g), so a gradient near zero may flip one element by up to
      2*lr), the EMA per leaf to 1e-5 rel;
  (b) the fast preset: tests/test_torch_train_fast_preset.py (its own
      file, so that the two JAX compiles run on two test workers).

Both optimizers start from update count 1000 with state step 1000 (optax
schedules read the optimizer's own count, not the state's step). Also
here, without JAX: the frozen encoders from seeds, the unported option
raising, and the written-out sample axis against a per-sample loop.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervla_tpu.flagship import build_flagship as jax_build
from hypervla_tpu.flagship import make_flagship_batch as jax_batch
from hypervla_tpu.parallel.mesh import create_mesh, replicated, shard_batch
from hypervla_tpu.train import optimizer as jopt
from hypervla_tpu.train.train_state import TrainState as JaxTrainState
from hypervla_tpu.train.train_step import make_train_step as jax_make_step
from hypervla_tpu_torch.flagship import build_flagship, make_flagship_batch
from hypervla_tpu_torch.models.hypernetwork import per_sample_view
from hypervla_tpu_torch.train import optimizer as topt
from hypervla_tpu_torch.train.train_state import TrainState
from hypervla_tpu_torch.train.train_step import make_train_step, to_tensors
from hypervla_tpu_torch.train.trainer import (
    build_frozen_encoders,
    frozen_layer_kernel,
)
from hypervla_tpu_torch.utils.convert import flatten_tree, from_jax_params
from test_torch_harness import torch_threads  # noqa: F401

STEP0 = 1000
BATCH = dict(batch_size=8, instr_len=8, action_horizon=2)


def _with_count(opt_state, count):
    """The JAX optimizer state with every optax update count set."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(count, x.dtype)
        if getattr(path[-1], "name", None) == "count" else x, opt_state)


def _jax_step(model, config, batch, encoders=None, mesh=None):
    """One JAX step on `mesh` (None: every device, the 8 CPU devices of
    tests/conftest.py)."""
    text_apply, dino_apply, enc_params = encoders or (None, None, None)
    tx, lr_fn, base_lr_fn, pnorm_fn = jopt.create_optimizer(
        model.params, jopt.hn_param_type_tree(model.params),
        **config["optimizer"])
    mesh = mesh or create_mesh()
    step_fn = jax_make_step(model, config, tx, lr_fn, base_lr_fn, pnorm_fn,
                            text_encode=text_apply, dino_encode=dino_apply,
                            mesh=mesh, donate=False)
    state = JaxTrainState.create(jax.random.PRNGKey(0), model.params, tx,
                                 track_ema=True)
    state = state.replace(step=jnp.asarray(STEP0),
                          opt_state=_with_count(state.opt_state, STEP0))
    state = jax.device_put(state, replicated(mesh))
    new, info = step_fn(state, shard_batch(copy.deepcopy(batch), mesh),
                        encoder_params=enc_params)
    return (flatten_tree(jax.device_get(new.params)),
            flatten_tree(jax.device_get(new.ema_params)),
            {k: float(v) for k, v in info.items()})


def _torch_step(model, config, batch, encoders=None):
    text_apply, dino_apply, enc_params = encoders or (None, None, None)
    tx, lr_fn, base_lr_fn, pnorm_fn = topt.create_optimizer(
        model.params, topt.hn_param_type_tree(model.params),
        **config["optimizer"])
    step_fn = make_train_step(model, config, tx, lr_fn, base_lr_fn,
                              pnorm_fn, text_encode=text_apply,
                              dino_encode=dino_apply)
    state = TrainState.create(model.params, tx, track_ema=True)
    state.step = STEP0
    state.opt_state["count"] = STEP0
    new, info = step_fn(state, batch, encoder_params=enc_params)
    return ({k: v.detach().numpy() for k, v in new.params.items()},
            {k: v.numpy() for k, v in new.ema_params.items()},
            {k: float(v) for k, v in info.items()})


def _cosine(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    n = np.linalg.norm(a) * np.linalg.norm(b)
    if n == 0:
        return 1.0 if np.allclose(a, b) else 0.0
    return float(a @ b / n)


def test_fp32_step_matches_jax():
    jmodel, _ = jax_build(tiny=True, training=True)
    config = copy.deepcopy(jmodel.config)
    config["EMA_start_step"] = 0
    jmodel = jmodel.replace(config=config)
    batch = jax_batch(**BATCH, initial_patch_dim=32)
    ref_params, ref_ema, ref_info = _jax_step(jmodel, config, batch)

    model, _ = build_flagship(tiny=True, training=True, encoder_dtype=None,
                              device="cpu")
    model.config["EMA_start_step"] = 0
    model.params = from_jax_params(jmodel.params)
    old = {k: v.numpy() for k, v in model.params.items()}
    got_params, got_ema, info = _torch_step(
        model, model.config, make_flagship_batch(**BATCH,
                                                 initial_patch_dim=32))

    assert set(got_params) == set(ref_params)
    for key in ("training_loss", "grad_norm"):
        np.testing.assert_allclose(info[key], ref_info[key], rtol=1e-5,
                                   err_msg=key)
    for key in ("update_norm", "param_norm", "continuous_loss",
                "gripper_loss", "base_params_norm", "learning_rate"):
        np.testing.assert_allclose(info[key], ref_info[key], rtol=1e-4,
                                   err_msg=key)
    updates = {name: (got_params[name] - old[name],
                      np.asarray(ref) - old[name])
               for name, ref in ref_params.items()}
    typical = np.median([np.linalg.norm(r) for _, r in updates.values()])
    for name, (got, ref) in updates.items():
        if np.linalg.norm(ref) < 1e-3 * typical:
            # a degenerate leaf (the key bias: softmax ignores a uniform
            # key shift, so its exact gradient is 0 and both steps move it
            # by rounding noise): the port's noise must be as small
            assert np.linalg.norm(got) < 1e-2 * typical, name
        else:
            assert _cosine(got, ref) > 0.999, name
        np.testing.assert_allclose(got_ema[name], np.asarray(ref_ema[name]),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


def test_build_frozen_encoders_shapes():
    """The port's frozen encoders from seeds: T5 token embeddings and the
    conditioning DINOv2's fp32 last_hidden_state, CLS token included."""
    model, batch = build_flagship(tiny=True, training=True,
                                  encoder_dtype=None, device="cpu")
    config = copy.deepcopy(model.config)
    config["dataset_kwargs"]["text_tokenizer"] = "t5-small"
    text_apply, dino_apply, t5_params, dino_params = build_frozen_encoders(
        config, seed=3, device="cpu")
    ids = torch.as_tensor(batch["task"]["language_instruction"]["input_ids"])
    mask = torch.ones_like(ids)
    emb = text_apply(t5_params, ids, mask)
    assert emb.shape == (1, 8, 512) and emb.dtype == torch.float32
    images = torch.as_tensor(batch["initial_state"]["image_primary"][:, 0])
    with torch.no_grad():
        out = dino_apply(dino_params, images)
    assert out.shape == (1, 257, 32) and out.dtype == torch.float32
    assert torch.isfinite(out).all() and torch.isfinite(emb).all()
    assert not frozen_layer_kernel(config)  # fp32, 32 wide: the layer loop


@pytest.mark.parametrize("change", [
    # the attention aux losses, embedding noise and dropout now run
    # (tests/test_torch_attention_capture.py, test_torch_dropout.py), as
    # does device_augment (tests/test_torch_trainer.py)
    lambda c: c["base_net_kwargs"]["vit_kwargs"].update(
        flash_attention_trainable=True),
])
def test_unported_train_options_raise(change):
    model, _ = build_flagship(tiny=True, training=True, encoder_dtype=None,
                              device="cpu")
    config = copy.deepcopy(model.config)
    change(config)
    tx, lr_fn, base_lr_fn, pnorm_fn = topt.create_optimizer(
        model.params, topt.hn_param_type_tree(model.params),
        **dict(config["optimizer"], weight_decay_strategy="v1"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_train_step(model, config, tx, lr_fn, base_lr_fn, pnorm_fn)


def test_per_sample_view_matches_a_sample_loop():
    """The base-net loss with the sample axis written out equals the loss
    of each sample run alone on its own generated params."""
    model, _ = build_flagship(tiny=True, training=True, encoder_dtype=None,
                              device="cpu")
    gen = torch.Generator().manual_seed(0)
    for name, value in model.params.items():
        if name.startswith("output_head_") and name.endswith("/kernel"):
            value += torch.randn(value.shape, generator=gen) * 0.05
    batch = to_tensors(make_flagship_batch(**BATCH, initial_patch_dim=32),
                       "cpu")
    instr = batch["task"]["language_instruction"]
    emb = torch.randn(8, 256, 32, generator=gen)

    def losses(sl):
        ctx = model.hypernet.context_embedding(
            model.params, instr["token_embedding"][sl],
            instr["attention_mask"][sl],
            batch["task"]["pad_mask_dict"]["language_instruction"][sl],
            batch["initial_state"]["patch_embeddings"][sl])
        base = per_sample_view(model.plan, model.hypernet.generate(
            model.params, ctx))
        sub = {"action": batch["action"][sl],
               "action_pad_mask": batch["action_pad_mask"][sl],
               "observation": {"timestep_pad_mask":
                               batch["observation"]["timestep_pad_mask"][sl]}}
        return model.base_net.loss(base, sub, emb[sl])[0]

    batched = losses(slice(None))
    looped = torch.cat([losses(slice(i, i + 1)) for i in range(8)])
    assert batched.shape == (8,)
    torch.testing.assert_close(batched, looped, rtol=1e-5, atol=1e-6)
