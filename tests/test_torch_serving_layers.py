"""The port's per-layer serving path against the JAX package's, on the CPU,
with the same params and frames: make_serving_step without the stacked
trunk (JAX: trunk_kernel=False; the port: trunk_impl="layers") over the
bf16-stored per-layer leaves of prepare_serving_params, with
use_flash_attention=True (ops/flash_attention.py) and fused_layer_norm=True
(the one-pass LayerNorm of ops/layer_norm.py). JAX runs both Pallas kernels
in interpret mode, the port their plain versions.

  * bf16 (`dinov2-test-wide`, head dim 64): actions on the arm dims within
    0.05 * max(scale, 1), the bound the JAX package holds between its own
    bf16 trunks (tests/test_dino_layer_kernel.py), as
    tests/test_torch_serving.py does for the stacked trunk;
  * fp32 (`dinov2-test`): actions to 1e-4 (the flash kernel's own fp32 bound
    is 2e-5 on one attention; two layers and the policy ViT follow).
"""
import numpy as np
import pytest
import torch

from hypervla_tpu.ops import serving as jserving
from hypervla_tpu_torch.eval.inference import InferenceWrapper, initial_state
from hypervla_tpu_torch.ops import flash_attention as tfa
from hypervla_tpu_torch.ops import layer_norm as tln
from hypervla_tpu_torch.ops import serving
from test_torch_serving import BF16_BOUND, STATS, _build, _run_jax
from test_torch_harness import torch_threads  # noqa: F401

SWITCHES = dict(use_flash_attention=True, fused_layer_norm=True,
                sow_dino_attention=False)


def _run_port(model, params, frames, trunk_impl):
    step, init_history = serving.make_serving_step(
        model, STATS, crop=False, ensemble=True, trunk_impl=trunk_impl)
    history, out = init_history(), []
    for t, frame in enumerate(frames):
        action, history = step(params, frame, history, t)
        out.append(action.numpy())
    return np.stack(out)


@pytest.fixture(scope="module")
def bf16():
    return _build(dict(pretrained_encoder_name="dinov2-test-wide",
                       encoder_dtype="bfloat16", **SWITCHES), 128)


def _count_calls(monkeypatch):
    """Counts the calls of the two kernels' functions in the port's
    DINOv2."""
    from hypervla_tpu_torch.models.encoders import dinov2 as td

    seen = {"mha_flash": 0, "layer_norm_one_pass": 0}
    for name in seen:
        real = getattr(td, name)

        def counted(*args, _name=name, _real=real):
            seen[_name] += 1
            return _real(*args)

        monkeypatch.setattr(td, name, counted)
    return seen


def test_bf16_layer_loop_matches_jax(bf16, monkeypatch):
    jmodel, jbase, model, base, frames, tok = bf16
    vit = model.base_net.encoder
    assert vit.use_flash and vit.fused_ln is True and not vit.fused_add_ln
    jparams = jserving.prepare_serving_params(jmodel, jbase)
    ref = _run_jax(jmodel, jparams, frames, tok)  # trunk_kernel=False

    prepared = serving.prepare_serving_params(model, base, stack_trunk=False)
    enc = "encoder/image_encoder/"
    assert enc + "trunk/w" not in prepared
    assert prepared[enc + "encoder/layer/0/mlp/fc1/kernel"].dtype == (
        torch.bfloat16)
    assert prepared[enc + "layernorm/scale"].dtype == torch.bfloat16
    seen = _count_calls(monkeypatch)
    got = _run_port(model, prepared, frames, "layers")
    layers = vit.dino.num_hidden_layers
    assert seen == {"mha_flash": layers * len(frames),
                    "layer_norm_one_pass": (2 * layers + 1) * len(frames)}
    assert tfa.LAUNCHES["flash_attention"] == 0  # CPU: the plain versions
    assert tln.LAUNCHES["layer_norm"] == 0
    assert np.isfinite(got).all()
    arm_scale = max(np.abs(ref[:, :6]).max(), 1.0)
    assert np.abs(got[:, :6] - ref[:, :6]).max() < BF16_BOUND * arm_scale

    # with the kernels' plain versions asked for: the same functions here
    plain = _run_port(model, prepared, frames, "layers_reference")
    np.testing.assert_array_equal(plain, got)
    # and the stacked trunk over the same weights stays within the bound
    stacked = _run_port(model, serving.prepare_serving_params(model, base),
                        frames, "reference")
    assert np.abs(stacked[:, :6] - got[:, :6]).max() < BF16_BOUND * arm_scale


def test_fp32_layer_loop_matches_jax():
    jmodel, jbase, model, base, frames, tok = _build(SWITCHES, 32)
    ref = _run_jax(jmodel, jbase, frames, tok)
    # an fp32 config has nothing to prepare, and always runs the layer loop
    assert serving.prepare_serving_params(model, base,
                                          stack_trunk=False) is base
    for trunk_impl in ("layers", "kernel"):
        got = _run_port(model, base, frames, trunk_impl)
        np.testing.assert_allclose(got, ref, atol=1e-4)


def test_inference_wrapper_takes_the_layer_loop(bf16):
    _, _, model, _, frames, tok = bf16
    model.dataset_statistics = {"action": STATS}
    instruction = {"language_instruction": {
        "token_embedding": tok, "attention_mask": np.ones((1, tok.shape[1]),
                                                          np.int32)}}
    init = initial_state(model, frames[0])
    actions = {}
    for trunk_impl in ("layers", "kernel"):
        policy = InferenceWrapper(model, policy_setup="google_robot",
                                  image_size=224, crop=True,
                                  action_ensemble=True,
                                  trunk_impl=trunk_impl, fused_serving=True)
        policy.reset("task", instruction, init)
        stacked = "encoder/image_encoder/trunk/w" in policy.base_params
        assert stacked == (trunk_impl == "kernel")
        actions[trunk_impl] = np.stack([policy.step(f)[0] for f in frames])
        assert np.isfinite(actions[trunk_impl]).all()
    scale = max(np.abs(actions["kernel"][:, :6]).max(), 1.0)
    assert np.abs(actions["layers"][:, :6]
                  - actions["kernel"][:, :6]).max() < BF16_BOUND * scale


def test_unknown_trunk_impl_raises(bf16):
    model = bf16[2]
    for bad in ("pallas", "layer", True):
        with pytest.raises(ValueError, match="unknown trunk_impl"):
            serving.make_serving_step(model, STATS, trunk_impl=bad)
