"""The scanned trunk (vit_kwargs scan_dino_layers;
hypervla_tpu/models/encoders/dinov2.py:933-1003): the JAX package stacks
the trunk's layers under encoder/layers/layer, and in a HyperVLA's params
as flat shared leaves "<...>encoder_layers_layer_<leaf>";
utils/convert.py::from_jax_params unstacks both into the port's per-layer
keys, and the port runs its layer loop. On the tiny DINOv2 twin with the
trunk fine-tuned, on the CPU: the converted params are the port's, and one
step's loss and every gradient (the JAX gradients of the stacked leaves
unstacked) match the JAX reference through the scanned stack, to 1e-5
(the readout of the policy ViT alone: tests/test_torch_vit_switches.py::
test_lifted_switch_matches_jax[scan_dino_layers]). With attention capture
on, the scanned trunk stays refused, as in the JAX package."""
import jax
import numpy as np
import pytest

from hypervla_tpu_torch.configs import tiny_test_config
from hypervla_tpu_torch.flagship import make_flagship_batch
from hypervla_tpu_torch.models.draws import Draws
from hypervla_tpu_torch.models.hypervla import HyperVLA
from hypervla_tpu_torch.utils.convert import trunk_depth, unstack_trunk
from test_torch_harness import torch_threads  # noqa: F401
from test_torch_jax_draws import (
    PAIR_BATCH,
    assert_grads_close,
    build_pair,
    dropout_keys,
    jax_reference,
    port_step_grads,
)

BATCH = 2


def _scan(config):
    config["base_net_kwargs"]["vit_kwargs"].update(
        scan_dino_layers=True, sow_dino_attention=False,
        fine_tune_pretrained_image_encoder=True)


def test_scanned_trunk_step_matches_jax():
    jmodel, jconfig, model, config, jbatch, batch = build_pair(
        _scan, batch_size=BATCH)
    stacked = [k for k in jmodel.params if "_layers_layer_" in k]
    assert stacked and not any("_layer_0_" in k for k in jmodel.params)
    ref = jax_reference(jmodel, jconfig, jbatch,
                        dropout_keys(jax.random.PRNGKey(0), BATCH))
    info, grads = port_step_grads(model, config, batch,
                                  Draws(replay=ref["sites"]))
    np.testing.assert_allclose(info["training_loss"], ref["loss"], rtol=1e-5)
    want = {k: np.asarray(v).reshape(grads[k].shape)
            for k, v in unstack_trunk(ref["grads"],
                                     trunk_depth(config)).items()}
    assert_grads_close(grads, want)
    trunk = [k for k in grads if "encoder_image_encoder_encoder_layer_1_" in k]
    assert trunk and all(np.abs(grads[k]).max() > 0 for k in trunk)


def test_unstack_trunk_splits_the_layer_axis():
    rng = np.random.default_rng(0)
    tree = {"image_encoder/encoder/layers/layer/mlp/fc1/kernel":
            rng.random((3, 4, 5)),
            "image_encoder/layernorm/scale": rng.random(4)}
    out = unstack_trunk(tree)
    assert set(out) == {f"image_encoder/encoder/layer/{i}/mlp/fc1/kernel"
                        for i in range(3)} | {"image_encoder/layernorm/scale"}
    for i in range(3):
        np.testing.assert_array_equal(
            out[f"image_encoder/encoder/layer/{i}/mlp/fc1/kernel"],
            tree["image_encoder/encoder/layers/layer/mlp/fc1/kernel"][i])
    flat = {"encoder_image_encoder_encoder_layers_layer_attention_attention_"
            "query_kernel": np.arange(2 * 3 * 3.0),
            "encoder_image_encoder_encoder_layers_layer_attention_attention_"
            "query_bias": np.arange(2 * 3.0)}
    with pytest.raises(ValueError, match="layer count"):
        unstack_trunk(flat)
    out = unstack_trunk(flat, layers=2)
    np.testing.assert_array_equal(
        out["encoder_image_encoder_encoder_layer_1_attention_attention_"
            "query_kernel"], np.arange(9.0, 18.0))
    np.testing.assert_array_equal(
        out["encoder_image_encoder_encoder_layer_1_attention_attention_"
            "query_bias"], np.arange(3.0, 6.0))


def test_scan_with_capture_is_refused():
    config = tiny_test_config()
    config["base_net_kwargs"]["vit_kwargs"]["scan_dino_layers"] = True
    with pytest.raises(AssertionError, match="sow_dino_attention"):
        HyperVLA.from_config(config, make_flagship_batch(**PAIR_BATCH),
                             device="cpu")
