"""One fp32 step of the port's train step on the SmallStem HyperVLA (no
shared trunk to hoist: the generated stem, ViT and head run per sample, the
convolutions grouped by sample) against the JAX package's step, which vmaps
the base-net loss over the per-sample generated params; the JAX tiny
SmallStem config at 64 px, batch 8, from the same params with perturbed
fan-out kernels. As
tests/test_torch_train_step.py holds the flagship's step: loss and
grad_norm to 1e-5 relative, the other metrics to 1e-4, the update per leaf
at cosine > 0.999, the EMA to 1e-5, both optimizers from update count 1000.

Two kinds of leaf have an exact gradient of 0, so both steps move them by
rounding noise that Adam's normalisation scales up: the attention's key
biases (softmax ignores a uniform key shift) and, at 32 channels and 32
groups, the stem's conv biases (each GroupNorm group is one channel, whose
mean the norm removes), with the fan-out heads that generate them. For
those the port's move must be as small as the JAX step's bound allows.

The JAX step runs on a mesh of one CPU device. On tests/conftest.py's 8
virtual CPU devices the JAX step's loss on this config depends on the mesh
(17.4139, 17.2160 and 18.2195 on 1, 2 and 8 devices in the full/continuous
case): XLA's partitioning of the vmapped stem over a batch sharded across
the devices gives other stem outputs than the unsharded program. The
port's loss is the 1-device step's, and a plain loop over the samples
through the JAX modules (no vmap, no mesh) gives it too, which the test
checks.
"""
import re

import flax
import jax
import numpy as np
import pytest

from helpers import make_example_batch
from hypervla_tpu.models.base_network import BaseNetwork as JaxBaseNetwork
from hypervla_tpu.models.hypervla import HyperVLA as JaxHyperVLA
from hypervla_tpu.parallel.mesh import create_mesh
from hypervla_tpu_torch.models.hypervla import HyperVLA, _unflatten
from hypervla_tpu_torch.utils.convert import flatten_tree, from_jax_params
from test_torch_smallstem_slice import (
    SIZE,
    jax_config,
    perturbed_kernels,
    port_config,
)
from test_torch_train_step import _cosine, _jax_step, _torch_step
from test_torch_harness import torch_threads  # noqa: F401

#: leaves whose exact gradient is 0 (see the module docstring)
DEGENERATE = re.compile(r"key[/_]bias|StdConv_\d[/_]bias")


@pytest.mark.parametrize("strategy,head", [("full", "continuous"),
                                           ("block", "mix")])
def test_fp32_step_matches_jax(strategy, head):
    batch = make_example_batch(batch_size=8, image_size=SIZE)
    config = jax_config(strategy, head)
    config["EMA_start_step"] = 0
    jmodel = JaxHyperVLA.from_config(config, batch, jax.random.PRNGKey(0))
    flat = perturbed_kernels(flatten_tree(jax.tree_util.tree_map(
        np.asarray, flax.core.unfreeze(jmodel.params))))
    jmodel = jmodel.replace(params=_unflatten(flat))
    ref_params, ref_ema, ref_info = _jax_step(
        jmodel, config, batch, mesh=create_mesh(jax.devices()[:1]))

    pconfig = port_config(strategy, head)
    pconfig["EMA_start_step"] = 0
    model = HyperVLA.from_config(pconfig, batch, device="cpu")
    model.params = from_jax_params(jmodel.params)
    old = {k: v.numpy() for k, v in model.params.items()}
    got_params, got_ema, info = _torch_step(model, pconfig, batch)

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
    degenerate = 0
    for name, (got, ref) in updates.items():
        if DEGENERATE.search(name):
            degenerate += 1
            assert max(np.linalg.norm(got),
                       np.linalg.norm(ref)) < 0.1 * typical, name
        elif np.linalg.norm(ref) < 1e-3 * typical:
            assert np.linalg.norm(got) < 1e-2 * typical, name
        else:
            assert _cosine(got, ref) > 0.999, name
        np.testing.assert_allclose(got_ema[name], np.asarray(ref_ema[name]),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    assert degenerate > 0
    np.testing.assert_allclose(info["training_loss"],
                               _jax_sample_loop_loss(jmodel, batch),
                               rtol=1e-5)


def _jax_sample_loop_loss(jmodel, batch):
    """The batch's mean loss from the JAX modules, one sample at a time."""
    flags = flax.core.unfreeze(
        jmodel.hypernet.base_net_metadata["generation_flag"])
    losses = []
    for i in range(len(batch["action"])):
        sample = jax.tree_util.tree_map(lambda x: np.asarray(x)[i:i + 1],
                                        batch)
        generated, _ = jmodel.hypernet.apply(
            {"params": jmodel.params}, sample["task"], train=False,
            broadcast_shared=False)
        generated = jax.tree_util.tree_map(
            lambda p, g: p[0] if g else p, flax.core.unfreeze(generated),
            flags)
        loss, _, _ = jmodel.base_net.apply(
            {"params": generated}, sample, train=False,
            method=JaxBaseNetwork.loss)
        losses.append(float(loss))
    return float(np.mean(losses))
