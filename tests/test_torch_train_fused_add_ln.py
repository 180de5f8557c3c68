"""One step of the port's train step with the fused residual boundaries
against the JAX package's, from the same params and batch, on the tiny
flagship twin with dinov2-test-wide on the CPU (JAX's Pallas kernels in
interpret mode; the port's plain versions): the fast preset plus
vit_kwargs dino_fused_add_ln=True, the trunk fine-tuned, so every residual
boundary of the bf16 trunk but the last runs fused_add_scale_ln forward and
backward (ops/add_layer_norm.py) around the fused training attention. Loss
within 2e-2 rel and the post-update params per leaf at cosine > 0.98, the
bounds of tests/test_torch_train_fast_preset.py. The param layout does not
change with the switch: the JAX model's params go through
utils/convert.py::from_jax_params as they are.

Also here, without JAX: the trunk in the delayed-residual form against the
plain layer loop, in fp32 where the two are the same function up to the
order of the sums, outputs and gradients.
"""
import dataclasses

import jax
import numpy as np
import torch

from hypervla_tpu.configs import apply_fast_training_preset as jax_preset
from hypervla_tpu.configs import tiny_test_config as jax_tiny_config
from hypervla_tpu.flagship import make_flagship_batch as jax_batch
from hypervla_tpu.models.hypervla import HyperVLA as JaxHyperVLA
from hypervla_tpu_torch import configs
from hypervla_tpu_torch.configs import (
    apply_fast_training_preset,
    tiny_test_config,
)
from hypervla_tpu_torch.flagship import make_flagship_batch
from hypervla_tpu_torch.models.base_vit import normalize_pixels
from hypervla_tpu_torch.models.encoders import dinov2 as td
from hypervla_tpu_torch.models.encoders import t5 as tt5
from hypervla_tpu_torch.models.hypervla import HyperVLA
from hypervla_tpu_torch.ops import add_layer_norm as aln
from hypervla_tpu_torch.utils.convert import flatten_tree, from_jax_params
from test_torch_train_fast_preset import T5_SMALL, _jax_encoders
from test_torch_train_step import BATCH, _cosine, _jax_step, _torch_step
from test_torch_harness import torch_threads  # noqa: F401


def _slice_config(config, preset):
    vk = config["base_net_kwargs"]["vit_kwargs"]
    vk.update(pretrained_encoder_name="dinov2-test-wide",
              fine_tune_pretrained_image_encoder=True)
    config = preset(config)
    config["base_net_kwargs"]["vit_kwargs"]["dino_fused_add_ln"] = True
    config["EMA_start_step"] = 0
    return config


def test_fused_add_ln_step_matches_jax(monkeypatch):
    config = _slice_config(jax_tiny_config(encoder_type="DINOv2"),
                           jax_preset)
    example = jax_batch(instr_len=8, action_horizon=2, initial_patch_dim=128)
    jmodel = JaxHyperVLA.from_config(config, example, jax.random.PRNGKey(0))
    batch = jax_batch(**BATCH, initial_patch_dim=128)
    del batch["task"]["language_instruction"]["token_embedding"]
    del batch["initial_state"]["patch_embeddings"]
    encoders = _jax_encoders(jmodel)
    ref_params, _, ref_info = _jax_step(jmodel, config, batch, encoders)

    config = _slice_config(tiny_test_config(), apply_fast_training_preset)
    model = HyperVLA.from_config(config, make_flagship_batch(
        instr_len=8, action_horizon=2, initial_patch_dim=128),
        device="cpu")
    converted = from_jax_params(jmodel.params)
    # the fused modules keep nn.LayerNorm's and _LayerScale's param names
    assert set(converted) == set(model.params)
    assert set(converted) == set(flatten_tree(jax.device_get(jmodel.params)))
    model.params = converted
    encoder = model.base_net.encoder
    assert encoder.fused_add_ln and encoder.fused_attention
    assert not encoder.layer_kernel
    enc = {k: from_jax_params(v) for k, v in encoders[2].items()}
    t5_cfg = tt5.T5Config(**T5_SMALL)
    enc["dino"] = td.pack_frozen_layers(encoder.dino, enc["dino"])

    def text_apply(params, ids, mask):
        return tt5.t5_encode(t5_cfg, params, ids, mask)

    def dino_apply(params, images):
        return td.dinov2_forward(encoder.dino, params,
                                 normalize_pixels(images), torch.bfloat16,
                                 layer_kernel=True)

    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = aln.add_ln_fwd, aln.add_ln_bwd
    monkeypatch.setattr(aln, "add_ln_fwd", lambda *a: (
        calls.__setitem__("fwd", calls["fwd"] + 1), fwd(*a))[1])
    monkeypatch.setattr(aln, "add_ln_bwd", lambda *a: (
        calls.__setitem__("bwd", calls["bwd"] + 1), bwd(*a))[1])
    got_params, _, info = _torch_step(model, config, batch,
                                      (text_apply, dino_apply, enc))
    boundaries = 2 * encoder.dino.num_hidden_layers - 1
    assert calls == {"fwd": boundaries, "bwd": boundaries}
    loss, ref_loss = info["training_loss"], ref_info["training_loss"]
    assert np.isfinite(loss)
    assert abs(loss - ref_loss) < 0.02 * abs(ref_loss), (loss, ref_loss)
    for name, ref in ref_params.items():
        if np.linalg.norm(np.asarray(ref)) < 1e-6:
            # a degenerate leaf (a zero-initialised key bias: softmax
            # ignores a uniform key shift, so its exact gradient is 0 and
            # both steps move it by rounding noise, where a leaf that learns
            # moves by ~lr = 1.5e-4 per element): the port's must be as small
            assert np.linalg.norm(got_params[name]) < 1e-6, name
        else:
            assert _cosine(got_params[name], np.asarray(ref)) > 0.98, name


def test_delayed_residual_trunk_equals_the_layer_loop():
    """fp32, three layers: the delayed-residual form (norm1 of layer 0
    plain, five fused boundaries, the last residual added outside) against
    the plain loop: output to 1e-4 of its scale, per-leaf gradient cosine
    > 0.9999; the layer kernel wins where both switches are set."""
    cfg = dataclasses.replace(configs.dinov2_config("dinov2-test"),
                              num_hidden_layers=3)
    gen = torch.Generator().manual_seed(0)
    params = {k[len("d/"):]: init(shape, gen).float()
              for k, (shape, init) in td.dinov2_specs(cfg, "d").items()}
    for v in params.values():
        if v.dim() == 1:
            v += 0.1 * torch.randn(v.shape, generator=gen)
    pixels = torch.randn((2, 224, 224, 3), generator=gen)
    cot = torch.randn((2, 257, cfg.hidden_size), generator=gen)

    def run(**kw):
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in params.items()}
        out = td.dinov2_forward(cfg, leaves, pixels, **kw)
        (out * cot).sum().backward()
        return out.detach(), leaves

    got, leaves = run(fused_add_ln=True)
    ref, ref_leaves = run()
    assert (got - ref).abs().max() <= 1e-4 * max(float(ref.abs().max()), 1.0)
    for name, leaf in ref_leaves.items():
        if leaf.grad is None or float(leaf.grad.norm()) < 1e-6:
            continue
        assert _cosine(leaves[name].grad.numpy(),
                       leaf.grad.numpy()) > 0.9999, name


def test_layer_kernel_wins_over_fused_add_ln(monkeypatch):
    monkeypatch.setattr(td, "fused_add_scale_ln", None)  # must not be called
    cfg = configs.dinov2_config("dinov2-test-wide")
    gen = torch.Generator().manual_seed(1)
    params = {k[len("d/"):]: init(shape, gen).float()
              for k, (shape, init) in td.dinov2_specs(cfg, "d").items()}
    pixels = torch.randn((1, 224, 224, 3), generator=gen)
    with torch.no_grad():
        both = td.dinov2_forward(cfg, params, pixels, torch.bfloat16,
                                 layer_kernel=True, fused_add_ln=True)
        alone = td.dinov2_forward(cfg, params, pixels, torch.bfloat16,
                                  layer_kernel=True)
    assert torch.equal(both, alone)
