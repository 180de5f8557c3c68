"""Attention-map capture and the two attention aux losses
(hypervla_tpu/train/train_step.py:166-190), against the JAX package on the
tiny DINOv2 twin on the CPU:

  * one training step with attention_entropy 0.1 and
    attention_map_alignment 0.2 at step 1000 (the alignment annealed by
    1 - step / num_steps), the policy ViT returning its attention map and
    a seeded DINO_last_layer_attention_map in the batch: the loss, both
    metrics and every gradient to 1e-5
    (tests/test_torch_jax_draws.py::jax_reference);
  * without the reference map the step raises KeyError naming it, and
    without return_attention_map the aux losses raise TypeError, in both
    packages;
  * the trunk's maps and save_attention_map:
    tests/test_torch_save_attention_map.py.
"""
import copy

import jax
import numpy as np
import pytest

from hypervla_tpu_torch.train import optimizer as topt
from hypervla_tpu_torch.train.train_step import REFERENCE_MAP, make_train_step
from test_torch_harness import torch_threads  # noqa: F401
from test_torch_jax_draws import (
    assert_grads_close,
    build_pair,
    dropout_keys,
    jax_reference,
    port_step_grads,
)

BATCH = 4
STEP = 1000


def _aux(config):
    config["auxiliary_loss"].update(attention_entropy=0.1,
                                    attention_map_alignment=0.2)
    config["base_net_kwargs"]["vit_kwargs"]["return_attention_map"] = True


def _reference_map(batch):
    """A seeded map whose [:, :, 0, 1:] rows hold the 256 patches'
    share."""
    m = np.random.default_rng(3).random((BATCH, 2, 1, 257)).astype(
        np.float32)
    batch["observation"][REFERENCE_MAP] = m / m.sum(-1, keepdims=True)


@pytest.fixture(scope="module")
def pair():
    return build_pair(_aux, batch_size=BATCH, batch_change=_reference_map)


def test_aux_loss_step_matches_jax(pair):
    jmodel, jconfig, model, config, jbatch, batch = pair
    assert config["base_net_kwargs"]["vit_kwargs"].get(
        "sow_dino_attention", True)  # the trunk on the capture route
    ref = jax_reference(jmodel, jconfig, jbatch,
                        dropout_keys(jax.random.PRNGKey(0), BATCH), STEP)
    info, grads = port_step_grads(model, config, batch, None, STEP)
    np.testing.assert_allclose(info["training_loss"], ref["loss"], rtol=1e-5)
    for key in ("attention_entropy_loss", "attention_alignment_loss"):
        np.testing.assert_allclose(
            info[key], float(np.mean(ref["metrics"][key])), rtol=1e-5,
            err_msg=key)
    assert_grads_close(grads, ref["grads"])


def test_missing_reference_map_and_map_raise_as_in_jax(pair):
    jmodel, jconfig, model, config, jbatch, batch = pair
    keys = dropout_keys(jax.random.PRNGKey(0), BATCH)
    jb = copy.deepcopy(jbatch)
    del jb["observation"][REFERENCE_MAP]
    with pytest.raises(KeyError, match=REFERENCE_MAP):
        jax_reference(jmodel, jconfig, jb, keys, STEP, grad=False)
    b = copy.deepcopy(batch)
    del b["observation"][REFERENCE_MAP]
    with pytest.raises(KeyError, match=REFERENCE_MAP):
        port_step_grads(model, config, b, None, STEP)

    no_map = copy.deepcopy(config)
    no_map["base_net_kwargs"]["vit_kwargs"]["return_attention_map"] = False
    tx, lr_fn, base_lr_fn, pnorm_fn = topt.create_optimizer(
        model.params, topt.hn_param_type_tree(model.params),
        **config["optimizer"])
    with pytest.raises(TypeError, match="return_attention_map"):
        make_train_step(model, no_map, tx, lr_fn, base_lr_fn, pnorm_fn)
    jno_map = copy.deepcopy(jconfig)
    jno_map["base_net_kwargs"]["vit_kwargs"]["return_attention_map"] = False
    from hypervla_tpu.models.base_network import BaseNetwork as JaxBaseNet

    jm = jmodel.replace(base_net=JaxBaseNet(**jno_map["base_net_kwargs"],
                                            octo_kwargs=jno_map["model"]))
    with pytest.raises(TypeError):
        jax_reference(jm, jno_map, jbatch, keys, STEP, grad=False)
