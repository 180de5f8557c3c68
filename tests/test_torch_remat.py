"""Layer remat of the trunk (vit_kwargs remat_dino, dino_remat_policy;
hypervla_tpu/models/encoders/dinov2.py::_remat_policy), on the tiny
DINOv2 twin with the trunk fine-tuned (so that its layers take gradients),
on the CPU:

  * every setting (remat_dino, and the policies "nothing", "dots",
    "dots_no_batch") gives the gradients of the step without remat bit for
    bit, on the fp32 trunk and on the bf16 trunk with the fused training
    attention (whose autograd.Function runs inside the recompute), the
    dropout draws replayed the same;
  * remat_dino and "nothing" match the JAX reference with the same
    setting (tests/test_torch_jax_draws.py::jax_reference) to 1e-5
    (tests/test_torch_remat_policy.py: "dots", "dots_no_batch").
"""
import jax
import numpy as np
import pytest
import torch

from hypervla_tpu_torch.models.draws import Draws, draws_generator
from hypervla_tpu_torch.models.encoders import dinov2 as td
from test_torch_harness import torch_threads  # noqa: F401
from test_torch_jax_draws import (
    assert_grads_close,
    build_pair,
    dropout_keys,
    jax_reference,
    port_step_grads,
    with_config,
)

BATCH = 2
#: the settings: {vit_kwargs change}
SETTINGS = {
    "remat_dino": {"remat_dino": True},
    "nothing": {"dino_remat_policy": "nothing"},
    "dots": {"dino_remat_policy": "dots"},
    "dots_no_batch": {"dino_remat_policy": "dots_no_batch"},
}


def _fine_tune(config):
    config["base_net_kwargs"]["vit_kwargs"][
        "fine_tune_pretrained_image_encoder"] = True
    config["hypernet_kwargs"]["context_encoder_kwargs"]["dropout_rate"] = 0.1


def _setting(name):
    def change(config):
        config["base_net_kwargs"]["vit_kwargs"].update(SETTINGS[name])
    return change


@pytest.fixture(scope="module")
def pair():
    return build_pair(_fine_tune, batch_size=BATCH)


def _grads(pair, change=None, bf16=False):
    def both(config):
        if bf16:
            config["base_net_kwargs"]["vit_kwargs"].update(
                encoder_dtype="bfloat16", dino_fused_attention=True,
                sow_dino_attention=False)
        if change is not None:
            change(config)
    _, _, model, config, _, batch = with_config(pair, both)
    draws = Draws(draws_generator(0, 0, "cpu"))
    return port_step_grads(model, config, batch, draws)[1], model


@pytest.mark.parametrize("bf16", [False, True])
def test_remat_changes_no_gradient(pair, monkeypatch, bf16):
    base, _ = _grads(pair, bf16=bf16)
    trunk = [k for k in base if k.startswith("encoder_image_encoder_encoder")]
    assert trunk and all(np.abs(base[k]).max() > 0 for k in trunk)
    calls = []
    real = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for name in SETTINGS:
        calls.clear()
        got, model = _grads(pair, _setting(name), bf16)
        assert len(calls) == model.base_net.encoder.dino.num_hidden_layers
        for key, value in base.items():
            np.testing.assert_array_equal(got[key], value,
                                          err_msg=f"{name} {key}")


def test_remat_policies_save_what_they_name():
    assert td.REMAT_SAVED["dots"] == ("mm", "addmm", "bmm")
    assert td.REMAT_SAVED["dots_no_batch"] == ("mm", "addmm")
    with pytest.raises(KeyError):
        td.remat_context("everything")


@pytest.mark.parametrize("name", ["remat_dino", "nothing"])
def test_remat_matches_jax(pair, name):
    jmodel, jconfig, model, config, jbatch, batch = with_config(
        pair, _setting(name))
    ref = jax_reference(jmodel, jconfig, jbatch,
                        dropout_keys(jax.random.PRNGKey(0),
                                     BATCH))
    info, grads = port_step_grads(model, config, batch,
                                  Draws(replay=ref["sites"]))
    np.testing.assert_allclose(info["training_loss"], ref["loss"], rtol=1e-5)
    assert_grads_close(grads, ref["grads"])


@pytest.mark.parametrize("name,recomputed", [
    ("remat_dino", True), ("nothing", True), ("dots", False),
    ("dots_no_batch", False)])
def test_each_policy_recomputes_what_it_does_not_save(name, recomputed):
    """A trunk layer's backward under each setting, counted by aten op:
    plain remat and "nothing" run the layer's matrix products (aten.mm)
    again, "dots" and "dots_no_batch" keep them; the batched products
    (aten.bmm, the einsum attention) only "dots" keeps."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from hypervla_tpu_torch.configs import DINOv2Config

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func)
            return func(*args, **(kwargs or {}))

    config = DINOv2Config(hidden_size=32, num_hidden_layers=1,
                          num_attention_heads=2, image_size=28)
    specs = td.dinov2_specs(config, "t")
    gen = torch.Generator().manual_seed(0)
    params = {k[2:]: init(shape, gen).float().requires_grad_(True)
              for k, (shape, init) in specs.items()}
    pixels = torch.randn(2, 28, 28, 3, generator=gen)

    def backward_ops(remat):
        out = td.dinov2_forward(config, params, pixels, remat=remat)
        with Count() as count:
            out.sum().backward()
        return count.ops

    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    plain = backward_ops(False)
    ops = backward_ops(True if name == "remat_dino"
                       else SETTINGS[name]["dino_remat_policy"])
    # the layer's six Dense products, run again in the recompute or not
    assert (ops.count(mm) - plain.count(mm) >= 6) == recomputed
    assert (ops.count(bmm) > plain.count(bmm)) == (name != "dots")
