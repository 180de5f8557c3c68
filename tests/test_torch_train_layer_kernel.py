"""One step of the port's train step with the layer-kernel trunk against
the JAX package's, from the same params and batch, on the tiny flagship
twin with dinov2-test-wide on the CPU (JAX's Pallas kernels in interpret
mode; the port's plain versions): the fast preset plus
hoist_shared_trunk, dino_layers_impl="pallas_train" and
fused_layer_norm="pallas_train", the trunk fine-tuned, so every trunk layer
runs the residual-saving layer forward and the layer backward, the frozen
DINOv2 the no-residual forward, and the final LayerNorm of both the
training LayerNorm. Loss within 2e-2 rel and the post-update params per
leaf at cosine > 0.98: the bounds the JAX package holds between its own
trunks (tests/test_layer_kernel_train_step.py, which is marked slow). Also
the config contract around it: the ValueError without the hoist, the
NotImplementedError for trunk switches with no counterpart, and each ported
switch selecting its kernel's function.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervla_tpu.configs import apply_fast_training_preset as jax_preset
from hypervla_tpu.configs import tiny_test_config as jax_tiny_config
from hypervla_tpu.flagship import make_flagship_batch as jax_batch
from hypervla_tpu.models.encoders.dinov2 import DINOv2Model, dinov2_config
from hypervla_tpu.models.encoders.t5 import T5Config, T5EncoderModel
from hypervla_tpu.models.hypernetwork import rebuild_shared_subtree
from hypervla_tpu.models.hypervla import HyperVLA as JaxHyperVLA
from hypervla_tpu_torch.configs import (
    apply_fast_training_preset,
    tiny_test_config,
)
from hypervla_tpu_torch.flagship import build_flagship, make_flagship_batch
from hypervla_tpu_torch.models.base_vit import normalize_pixels
from hypervla_tpu_torch.models.encoders import t5 as tt5
from hypervla_tpu_torch.models.encoders.dinov2 import (
    dinov2_forward,
    pack_frozen_layers,
)
from hypervla_tpu_torch.models.hypervla import HyperVLA
from hypervla_tpu_torch.ops import dino_layer_train as tdl
from hypervla_tpu_torch.train import optimizer as topt
from hypervla_tpu_torch.train.train_step import make_train_step
from hypervla_tpu_torch.train.trainer import frozen_layer_kernel
from hypervla_tpu_torch.utils.convert import from_jax_params
from test_torch_train_fast_preset import T5_SMALL
from test_torch_train_step import BATCH, _cosine, _jax_step, _torch_step
from test_torch_harness import torch_threads  # noqa: F401


def _slice_config(config, preset):
    """The slice's configuration on a tiny config of either package."""
    vk = config["base_net_kwargs"]["vit_kwargs"]
    vk.update(pretrained_encoder_name="dinov2-test-wide",
              fine_tune_pretrained_image_encoder=True)
    config = preset(config)
    config["hoist_shared_trunk"] = True
    vk = config["base_net_kwargs"]["vit_kwargs"]
    vk["dino_layers_impl"] = "pallas_train"
    vk["fused_layer_norm"] = "pallas_train"
    config["EMA_start_step"] = 0
    return config


def _jax_encoders(model):
    """The JAX step's frozen encoders: a small T5, and the conditioning
    DINOv2 as the JAX trainer builds it for this config (the Pallas layer
    forward, the training LayerNorm), its params a copy of the trunk's
    initial ones."""
    t5 = T5EncoderModel(config=T5Config(**T5_SMALL))
    ids = jnp.ones((1, BATCH["instr_len"]), jnp.int32)
    t5_params = t5.init(jax.random.PRNGKey(1), ids)["params"]
    dino = DINOv2Model(config=dinov2_config("dinov2-test-wide"),
                       dtype=jnp.bfloat16, layers_impl="pallas_train",
                       fused_ln="pallas_train")
    dino_params = jax.tree_util.tree_map(
        np.array, rebuild_shared_subtree(
            model.params, model.hypernet.base_net_metadata))
    mean = jnp.array((0.485, 0.456, 0.406))
    std = jnp.array((0.229, 0.224, 0.225))

    def dino_apply(params, images):
        raw = (images.astype(jnp.float32) / 255.0 - mean) / std
        return dino.apply({"params": params}, raw).last_hidden_state

    def text_apply(params, ids, mask):
        return t5.apply({"params": params}, ids, mask)

    return text_apply, dino_apply, {"t5": t5_params, "dino": dino_params}


def test_layer_kernel_step_matches_jax():
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
    model.params = from_jax_params(jmodel.params)
    encoder = model.base_net.encoder
    assert frozen_layer_kernel(config)
    assert encoder.layer_kernel and encoder.fused_ln == "pallas_train"
    enc = {k: from_jax_params(v) for k, v in encoders[2].items()}
    t5_cfg = tt5.T5Config(**T5_SMALL)
    enc["dino"] = pack_frozen_layers(encoder.dino, enc["dino"])

    def text_apply(params, ids, mask):
        return tt5.t5_encode(t5_cfg, params, ids, mask)

    def dino_apply(params, images):
        return dinov2_forward(encoder.dino, params, normalize_pixels(images),
                              torch.bfloat16, layer_kernel=True,
                              fused_ln="pallas_train")

    got_params, _, info = _torch_step(model, config, batch,
                                      (text_apply, dino_apply, enc))
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


def test_layer_kernel_trunk_reaches_the_fp32_leaves():
    """The trunk route alone: every layer through the differentiable layer,
    the gradients carried back to the per-layer fp32 leaves (the param
    layout does not change), against the same trunk through the plain layer
    loop: output within 0.03 * max(scale, 1) (the JAX package's bound
    between these two trunks) and, with one layer (stacked bf16 layers
    decorrelate two valid trunks), per-leaf gradient cosine > 0.99 (its
    bound, tests/test_dino_layer_train.py)."""
    import dataclasses

    from hypervla_tpu_torch import configs
    from hypervla_tpu_torch.models.encoders.dinov2 import dinov2_specs

    cfg = dataclasses.replace(configs.dinov2_config("dinov2-test-wide"),
                              num_hidden_layers=1)
    gen = torch.Generator().manual_seed(0)
    params = {k[len("d/"):]: init(shape, gen).float()
              for k, (shape, init) in dinov2_specs(cfg, "d").items()}
    for k, v in params.items():
        if v.dim() == 1:
            v += 0.1 * torch.randn(v.shape, generator=gen)
    pixels = torch.randn((2, 224, 224, 3), generator=gen)
    cot = torch.randn((2, 257, cfg.hidden_size), generator=gen)

    def run(**kw):
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in params.items()}
        out = dinov2_forward(cfg, leaves, pixels, torch.bfloat16, **kw)
        (out * cot).sum().backward()
        return out.detach(), leaves

    tdl.reset_launch_counts()
    got, leaves = run(layer_kernel=True, fused_ln="pallas_train")
    assert sum(tdl.LAUNCHES.values()) == 0  # CPU tensors: the plain versions
    ref, ref_leaves = run()
    assert (got - ref).abs().max() < 0.03 * max(float(ref.abs().max()), 1.0)
    norms = {k: float(v.grad.norm()) for k, v in ref_leaves.items()
             if v.grad is not None}
    typical = float(np.median(list(norms.values())))
    for name, norm in norms.items():
        grad = leaves[name].grad
        assert grad is not None and grad.dtype == torch.float32, name
        if norm < 1e-2 * typical:
            assert float(grad.norm()) < 1e-1 * typical, name
            continue
        assert _cosine(grad.numpy(), ref_leaves[name].grad.numpy()) > 0.99, (
            name)


def _make_step(config):
    model, _ = build_flagship(tiny=True, training=True, device="cpu")
    tx, lr_fn, base_lr_fn, pnorm_fn = topt.create_optimizer(
        model.params, topt.hn_param_type_tree(model.params),
        **config["optimizer"])
    return make_train_step(model, config, tx, lr_fn, base_lr_fn, pnorm_fn)


@pytest.mark.parametrize("change", [
    lambda c: c.pop("hoist_shared_trunk"),
    lambda c: c["base_net_kwargs"]["vit_kwargs"].update(
        sow_dino_attention=True),
    lambda c: c["base_net_kwargs"]["vit_kwargs"].update(
        image_embedding_noise=0.1),
    lambda c: c["hypernet_kwargs"].update(shared_modules=tuple()),
])
def test_layer_kernel_needs_the_hoisted_trunk(change):
    config = _slice_config(tiny_test_config(), apply_fast_training_preset)
    _make_step(copy.deepcopy(config))  # the slice's own config is taken
    change(config)
    with pytest.raises(ValueError, match="hoist"):
        _make_step(config)


@pytest.mark.parametrize("switch", [
    # the ids of the cases before the flash switches were lifted
    pytest.param({"dino_layers_impl": "unroll_serving"}, id="switch2"),
    pytest.param({"dino_layers_impl": "scan_serving"}, id="switch3"),
])
def test_unported_trunk_switches_raise(switch):
    """A trunk switch with no counterpart in the port raises at model build
    and at make_train_step, instead of running the plain trunk without a
    word."""
    config = tiny_test_config()
    config["base_net_kwargs"]["vit_kwargs"].update(switch)
    example = make_flagship_batch(instr_len=8, action_horizon=2,
                                  initial_patch_dim=32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        HyperVLA.from_config(config, example, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _make_step(config)


@pytest.mark.parametrize("switch,function,calls", [
    ({"use_flash_attention": True}, "mha_flash", 2),
    ({"fused_layer_norm": True}, "layer_norm_one_pass", 5),
    ({"dino_fused_add_ln": True}, "fused_add_scale_ln", 3),
    ({"use_flash_attention": True, "flash_attention_trainable": True},
     "mha_flash_trainable", 2),
    # without use_flash_attention the JAX trunk ignores it: the einsum route
    ({"flash_attention_trainable": True}, "mha_flash_trainable", 0),
])
def test_trunk_switch_selects_its_kernel(monkeypatch, switch, function,
                                         calls):
    """Each switch sends the two-layer trunk through its kernel's function:
    one attention per layer (the differentiable flash attention where
    flash_attention_trainable joins use_flash_attention, none without it);
    norm1, norm2 per layer and the final LayerNorm; every residual boundary
    but the last. With attention capture on (the default) the flash
    attentions and the fused boundaries stay off, as in the JAX
    package."""
    from hypervla_tpu_torch.models.encoders import dinov2 as td

    seen = []
    real = getattr(td, function)
    monkeypatch.setattr(td, function,
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    example = make_flagship_batch(instr_len=8, action_horizon=2,
                                  initial_patch_dim=32)
    images = torch.as_tensor(example["observation"]["image_primary"][:, 0])
    outs = {}
    for capture in (False, True):
        config = tiny_test_config()
        config["base_net_kwargs"]["vit_kwargs"].update(
            switch, sow_dino_attention=capture)
        model = HyperVLA.from_config(config, example, device="cpu")
        _make_step(config)  # the train step takes the config too
        seen.clear()
        with torch.no_grad():
            outs[capture] = model.base_net.encoder.train_image_embeddings(
                model.shared_params(), images)
        if capture and function != "layer_norm_one_pass":
            assert not seen
        else:
            assert len(seen) == calls
    # the same function up to rounding, on either route
    assert (outs[True] - outs[False]).abs().max() < 1e-4 * max(
        float(outs[True].abs().max()), 1.0)


def test_fused_add_ln_refuses_layer_remat():
    config = tiny_test_config()
    config["base_net_kwargs"]["vit_kwargs"].update(
        dino_fused_add_ln=True, sow_dino_attention=False, remat_dino=True)
    # the JAX package's AssertionError (tests/test_torch_vit_switches.py)
    with pytest.raises(AssertionError, match="remat"):
        HyperVLA.from_config(config, make_flagship_batch(
            instr_len=8, action_horizon=2, initial_patch_dim=32),
            device="cpu")


def test_layer_kernel_needs_a_bf16_trunk():
    config = tiny_test_config()
    config["base_net_kwargs"]["vit_kwargs"]["dino_layers_impl"] = (
        "pallas_train")
    with pytest.raises(ValueError, match="bf16"):
        HyperVLA.from_config(config, make_flagship_batch(
            instr_len=8, action_horizon=2, initial_patch_dim=32),
            device="cpu")
