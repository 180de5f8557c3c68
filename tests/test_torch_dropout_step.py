"""The JAX reference of the port's regularisation tests
(tests/test_torch_jax_draws.py::jax_reference: the JAX step's per-sample
loss, vmapped and jitted, its draws returned) held to the JAX train step
itself with the six dropout rates at 0.1 on the tiny DINOv2 twin (a
one-device mesh): its loss and gradient norm to 1e-5; and the port's step
with the reference's draws replayed, to the same step's loss and gradient
norm."""
import copy

import jax
import numpy as np

from hypervla_tpu.parallel.mesh import create_mesh, replicated, shard_batch
from hypervla_tpu.train import optimizer as jopt
from hypervla_tpu.train.train_state import TrainState as JaxTrainState
from hypervla_tpu.train.train_step import make_train_step as jax_make_step
from hypervla_tpu_torch.models.draws import Draws
from test_torch_dropout import BATCH, _all_rates, _keys
from test_torch_harness import torch_threads  # noqa: F401
from test_torch_jax_draws import build_pair, jax_reference, port_step_grads


def test_reference_and_port_match_the_jax_step():
    jmodel, jconfig, model, config, jbatch, batch = build_pair(
        _all_rates, batch_size=BATCH)
    tx, lr_fn, base_lr_fn, pnorm_fn = jopt.create_optimizer(
        jmodel.params, jopt.hn_param_type_tree(jmodel.params),
        **jconfig["optimizer"])
    mesh = create_mesh(jax.devices()[:1])
    step_fn = jax_make_step(jmodel, jconfig, tx, lr_fn, base_lr_fn,
                            pnorm_fn, mesh=mesh, donate=False)
    state = JaxTrainState.create(jax.random.PRNGKey(0), jmodel.params, tx,
                                 track_ema=False)
    state = jax.device_put(state, replicated(mesh))
    _, jinfo = step_fn(state, shard_batch(copy.deepcopy(jbatch), mesh))
    ref = jax_reference(jmodel, jconfig, jbatch, _keys(BATCH))
    norm = np.sqrt(sum(float((np.asarray(g, np.float64) ** 2).sum())
                       for g in ref["grads"].values()))
    for got in (ref["loss"], port_step_grads(
            model, config, batch, Draws(replay=ref["sites"]))[0][
                "training_loss"]):
        np.testing.assert_allclose(got, float(jinfo["training_loss"]),
                                   rtol=1e-5)
    np.testing.assert_allclose(norm, float(jinfo["grad_norm"]), rtol=1e-5)
