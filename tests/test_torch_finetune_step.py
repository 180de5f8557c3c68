"""Fine-tuning in the port against the JAX package: configs.py::
finetune_config against scripts/configs/finetune_config.py for the three
modes (and the command line's names for it), and two calls of the train
step under head_only with gradient accumulation (k = 2) against the JAX
step, on the tiny flagship twin (fp32, the JAX step on a mesh of one CPU
device), both optimizers at update count 1000:

  * the first call accumulates: every param stays as it was, bit for bit,
    in both packages; the second applies AdamW to the mean of the two
    clipped gradients: each trainable leaf's update at cosine > 0.999 to
    the JAX step's (as tests/test_torch_train_step.py holds one step), the
    frozen leaves bit-equal to where they started;
  * per call: training_loss and grad_norm (over every leaf, the frozen
    ones too) to 1e-5, learning_rate (read at the state's step, which
    advances on every call) and the EMA, which starts at the second call,
    to 1e-5."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hypervla_tpu.configs import flagship_pretrain_config as jax_flagship
from hypervla_tpu.flagship import build_flagship as jax_build
from hypervla_tpu.flagship import make_flagship_batch as jax_batch
from hypervla_tpu.parallel.mesh import create_mesh, replicated, shard_batch
from hypervla_tpu.train import optimizer as jopt
from hypervla_tpu.train.train_state import TrainState as JaxTrainState
from hypervla_tpu.train.train_step import make_train_step as jax_make_step
from hypervla_tpu_torch.configs import (
    FROZEN_KEYS_BY_MODE,
    finetune_config,
    flagship_pretrain_config,
)
from hypervla_tpu_torch.flagship import build_flagship, make_flagship_batch
from hypervla_tpu_torch.train import optimizer as topt
from hypervla_tpu_torch.train.main import load_config
from hypervla_tpu_torch.train.train_state import TrainState
from hypervla_tpu_torch.train.train_step import make_train_step
from hypervla_tpu_torch.utils.convert import flatten_tree, from_jax_params
from scripts.configs import finetune_config as jax_finetune
from test_torch_harness import torch_threads  # noqa: F401
from test_torch_weight_decay_steps import _cosine

STEP0 = 1000
BATCH = dict(batch_size=8, instr_len=8, action_horizon=2,
             initial_patch_dim=32)
SEEDS = (0, 1)


def _plain(value):
    return list(value) if isinstance(value, tuple) else value


def _flat(config):
    return {k: _plain(v) for k, v in flatten_tree(config).items()}


@pytest.mark.parametrize("mode", sorted(FROZEN_KEYS_BY_MODE))
def test_finetune_config_matches_jax(mode):
    """Every field of the port's copy is the JAX config's; the fields it
    leaves out are those its flagship pretraining config leaves out (the
    octo and CNN keys)."""
    string = f"vit_t,libero,{mode}"
    ref = _flat(jax_finetune.get_config(string).to_dict())
    got = finetune_config(string)
    flat = _flat(got)
    for key, value in flat.items():
        assert key in ref and ref[key] == value, key
    cut = set(_flat(jax_flagship())) - set(_flat(flagship_pretrain_config()))
    assert set(ref) - set(flat) == cut
    assert got["finetune_mode"] == mode
    assert tuple(got["optimizer"]["frozen_keys"]) == (
        jax_finetune.FROZEN_KEYS_BY_MODE[mode])
    for name in ("finetune_config", "scripts/configs/finetune_config.py"):
        assert load_config(f"{name}:{string}") == got
    with pytest.raises(ValueError, match="unknown finetune mode"):
        finetune_config("vit_t,libero,encoder_only")


def _with_count(opt_state, count):
    return jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(count, x.dtype)
        if getattr(path[-1], "name", None) == "count" else x, opt_state)


def _config(base):
    config = copy.deepcopy(base)
    config["optimizer"].update(frozen_keys=FROZEN_KEYS_BY_MODE["head_only"],
                               grad_accumulation_steps=2)
    config["EMA_start_step"] = STEP0 + 1
    return config


def _jax_calls(jmodel, config):
    tx, lr_fn, base_lr_fn, pnorm_fn = jopt.create_optimizer(
        jmodel.params, jopt.hn_param_type_tree(jmodel.params),
        **config["optimizer"])
    mesh = create_mesh(jax.devices()[:1])
    step_fn = jax_make_step(jmodel, config, tx, lr_fn, base_lr_fn, pnorm_fn,
                            mesh=mesh, donate=False)
    state = JaxTrainState.create(jax.random.PRNGKey(0), jmodel.params, tx,
                                 track_ema=True)
    state = state.replace(step=jnp.asarray(STEP0),
                          opt_state=_with_count(state.opt_state, STEP0))
    state = jax.device_put(state, replicated(mesh))
    out = []
    for seed in SEEDS:
        state, info = step_fn(state, shard_batch(jax_batch(**BATCH,
                                                           seed=seed), mesh))
        host = jax.device_get(state)
        out.append((flatten_tree(host.params), flatten_tree(host.ema_params),
                    {k: float(v) for k, v in info.items()}))
    return out


def _torch_calls(model, config):
    tx, lr_fn, base_lr_fn, pnorm_fn = topt.create_optimizer(
        model.params, topt.hn_param_type_tree(model.params),
        **config["optimizer"])
    step_fn = make_train_step(model, config, tx, lr_fn, base_lr_fn,
                              pnorm_fn)
    state = TrainState.create(model.params, tx, track_ema=True)
    state.step = STEP0
    state.opt_state["inner"]["count"] = STEP0
    out = []
    for seed in SEEDS:
        state, info = step_fn(state, make_flagship_batch(**BATCH, seed=seed))
        out.append(({k: v.detach().numpy() for k, v in state.params.items()},
                    {k: v.numpy() for k, v in state.ema_params.items()},
                    {k: float(v) for k, v in info.items()}))
    return out, state, tx


def test_head_only_accumulation_matches_jax():
    jmodel, _ = jax_build(tiny=True, training=True)
    config = _config(jmodel.config)
    jmodel = jmodel.replace(config=config)
    ref = _jax_calls(jmodel, config)

    model, _ = build_flagship(tiny=True, training=True, encoder_dtype=None,
                              device="cpu")
    model.params = from_jax_params(jmodel.params)
    old = {k: v.numpy().copy() for k, v in model.params.items()}
    got, state, tx = _torch_calls(model, _config(model.config))
    assert tx.frozen and len(tx.frozen) < len(old)
    assert state.step == STEP0 + 2
    assert state.opt_state["mini_step"] == 0
    assert state.opt_state["gradient_step"] == 1
    assert state.opt_state["inner"]["count"] == STEP0 + 1
    assert set(state.opt_state["inner"]["mu"]) == set(old) - tx.frozen

    for call, ((p, ema, info), (rp, rema, rinfo)) in enumerate(
            zip(got, ref)):
        for key in ("training_loss", "grad_norm", "learning_rate"):
            np.testing.assert_allclose(info[key], rinfo[key], rtol=1e-5,
                                       err_msg=f"call {call} {key}")
        for name, value in rema.items():
            np.testing.assert_allclose(ema[name], np.asarray(value),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"call {call} EMA {name}")
    # the first call only accumulates
    for params in (got[0][0], ref[0][0]):
        for name, value in old.items():
            assert np.array_equal(np.asarray(params[name]), value), name
    # the second applies the mean: trainable leaves as the JAX step moves
    # them, frozen ones where they started
    got_p, ref_p = got[1][0], ref[1][0]
    updates = {k: (got_p[k] - old[k], np.asarray(ref_p[k]) - old[k])
               for k in old if k not in tx.frozen}
    typical = np.median([np.linalg.norm(r) for _, r in updates.values()])
    for name, (g, r) in updates.items():
        assert np.linalg.norm(r) > 1e-3 * typical, name
        assert _cosine(g, r) > 0.999, name
    for name in tx.frozen:
        assert np.array_equal(got_p[name], old[name]), name
        assert np.array_equal(np.asarray(ref_p[name]), old[name]), name
