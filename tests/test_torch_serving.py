"""The port's closed-loop serving slice against the JAX package's, on the
CPU, with the same params (through utils/convert.py::from_jax_params) and
the same frames: per tick, resize -> base net -> unnormalise -> on-device
ensembling over the rolling history.

  * fp32 (`dinov2-test`): the JAX make_serving_step against the port's,
    actions to 1e-5;
  * bf16 (`dinov2-test-wide`, head dim 64): JAX's stacked trunk as the
    Pallas kernel in interpret mode against the port's plain trunk. The two
    round at the same points, but XLA may keep excess precision inside a
    fusion, so the bound is the 0.05 * max(scale, 1) the JAX package holds
    between its own bf16 trunks (tests/test_dino_layer_kernel.py:98),
    on the arm dims and on the gripper logits (the thresholded gripper
    flips when a logit sits near 0).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import make_example_batch
from hypervla_tpu.configs import tiny_test_config as jax_tiny_config
from hypervla_tpu.eval.action_ensemble import ActionEnsembler as JaxEnsembler
from hypervla_tpu.eval.inference import InferenceWrapper as JaxWrapper
from hypervla_tpu.models.base_network import BaseNetwork as JaxBaseNetwork
from hypervla_tpu.models.hypervla import HyperVLA as JaxHyperVLA
from hypervla_tpu.ops import serving as jserving
from hypervla_tpu_torch.configs import tiny_test_config
from hypervla_tpu_torch.eval.action_ensemble import ActionEnsembler
from hypervla_tpu_torch.eval.inference import InferenceWrapper, initial_state
from hypervla_tpu_torch.models.hypervla import HyperVLA
from hypervla_tpu_torch.ops import serving
from hypervla_tpu_torch.utils.convert import from_jax_params
from test_torch_harness import torch_threads  # noqa: F401

TICKS = 4
STATS = {
    "mean": np.arange(7, dtype=np.float32) / 10,
    "std": 1 + np.arange(7, dtype=np.float32) / 7,
    "mask": np.array([True] * 6 + [False]),
}
BF16_BOUND = 0.05


def _build(vit_overrides, patch_dim):
    """A JAX tiny DINOv2 model with perturbed fan-out kernels, its port
    twin on the same params, and both episodes' base params."""
    batch = make_example_batch(image_size=224, initial_image=True,
                               initial_patch_dim=patch_dim, seed=2)
    jconfig = jax_tiny_config(encoder_type="DINOv2")
    jconfig["base_net_kwargs"]["vit_kwargs"].update(vit_overrides)
    jmodel = JaxHyperVLA.from_config(jconfig, batch, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(np.asarray, jmodel.params)
    for name, head in params.items():
        if name.startswith("output_head_"):
            head["kernel"] = head["kernel"] + 0.02 * rng.standard_normal(
                head["kernel"].shape).astype(np.float32)
    jmodel = jmodel.replace(params=params)
    example = jax.tree_util.tree_map(lambda x: np.asarray(x)[:1], batch)
    instruction = {"language_instruction":
                   example["task"]["language_instruction"]}
    jbase, _, _ = jmodel.create_tasks(
        instruction_dict=instruction, initial_state=example["initial_state"])

    config = tiny_test_config()
    config["base_net_kwargs"]["vit_kwargs"].update(vit_overrides)
    model = HyperVLA.from_config(config, example, device="cpu")
    model.params = from_jax_params(params)
    base, _ = model.create_tasks(
        instruction_dict=instruction, initial_state=example["initial_state"])
    frames = np.random.default_rng(1).integers(
        0, 256, (TICKS, 224, 224, 3), dtype=np.uint8)
    token_embedding = example["task"]["language_instruction"][
        "token_embedding"]
    return jmodel, jbase, model, base, frames, token_embedding


def _run_jax(jmodel, params, frames, token_embedding, **kwargs):
    step, init_history = jserving.make_serving_step(
        jmodel, STATS, crop=False, ensemble=True, **kwargs)
    history, out = init_history(), []
    for t, frame in enumerate(frames):
        action, history = step(params, frame, token_embedding, history, t,
                               jax.random.PRNGKey(0))
        out.append(np.asarray(action))
    return np.stack(out)


def _run_port(model, params, frames):
    step, init_history = serving.make_serving_step(model, STATS, crop=False,
                                                   ensemble=True)
    history, out = init_history(), []
    for t, frame in enumerate(frames):
        action, history = step(params, frame, history, t)
        out.append(action.numpy())
    return np.stack(out)


@pytest.fixture(scope="module")
def fp32():
    return _build({}, 32)


@pytest.fixture(scope="module")
def bf16():
    return _build(dict(pretrained_encoder_name="dinov2-test-wide",
                       encoder_dtype="bfloat16", sow_dino_attention=False),
                  128)


def test_fp32_slice_matches_jax(fp32):
    jmodel, jbase, model, base, frames, tok = fp32
    ref = _run_jax(jmodel, jbase, frames, tok)
    got = _run_port(model, serving.prepare_serving_params(model, base),
                    frames)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_device_ensembling_matches_host_ensembler(fp32):
    """The serving step's on-device ensembling equals the host-side
    ActionEnsembler (of both packages) over unnormalised raw chunks."""
    _, _, model, base, frames, _ = fp32
    step, init_history = serving.make_serving_step(
        model, STATS, crop=False, ensemble=True)
    raw_step, _ = serving.make_serving_step(model, STATS, crop=False,
                                            ensemble=False)
    history = init_history()
    ours, theirs = ActionEnsembler(2), JaxEnsembler(2)
    for t, frame in enumerate(frames):
        action, history = step(base, frame, history, t)
        raw = model.sample_actions(frame[None], None, None, None,
                                   base)[0].numpy()
        raw = np.where(STATS["mask"], raw * STATS["std"] + STATS["mean"], raw)
        np.testing.assert_allclose(raw[0], raw_step(base, frame, None, t)[0],
                                   atol=1e-6)
        expected = ours.ensemble_action(raw)
        np.testing.assert_allclose(expected, theirs.ensemble_action(raw))
        np.testing.assert_allclose(action.numpy(), expected, atol=1e-5)


def test_bf16_slice_matches_jax_pallas_trunk(bf16):
    jmodel, jbase, model, base, frames, tok = bf16
    jparams = jserving.prepare_serving_params(jmodel, jbase)
    _, variables = jserving.make_pallas_trunk_net(jmodel, jparams)
    ref = _run_jax(jmodel, variables, frames, tok, trunk_kernel=True)
    prepared = serving.prepare_serving_params(model, base)
    assert prepared["encoder/image_encoder/trunk/w"].dtype == torch.bfloat16
    got = _run_port(model, prepared, frames)
    arm_scale = max(np.abs(ref[:, :6]).max(), 1.0)
    assert np.isfinite(got).all()
    assert np.abs(got[:, :6] - ref[:, :6]).max() < BF16_BOUND * arm_scale

    # gripper logits on the same frame, JAX Pallas trunk vs port trunk
    serve_net, _ = jserving.make_pallas_trunk_net(jmodel, jparams)
    image = frames[0][None]

    def jax_logits(module, images, tokens):
        readouts, _ = module.encode(images, tokens, train=False)
        return module.action_head(readouts, train=False)[1]

    ref_logits = np.asarray(serve_net.apply(
        variables, jnp.asarray(image), jnp.asarray(tok), method=jax_logits))
    tokens = model.base_net.encode(prepared, torch.from_numpy(image))
    logits = model.base_net.action_head(prepared, tokens)[1].numpy()
    scale = max(np.abs(ref_logits).max(), 1.0)
    assert np.abs(logits - ref_logits).max() < BF16_BOUND * scale


def test_inference_wrapper_steps_and_postprocess(bf16):
    """reset/step give finite (7,) actions; the host post-processing
    (google-robot sticky gripper, widowx, libero) matches the JAX
    wrapper's on the same raw actions."""
    _, _, model, _, frames, tok = bf16
    model.dataset_statistics = {"action": STATS}
    instruction = {"language_instruction": {
        "token_embedding": tok, "attention_mask": np.ones((1, tok.shape[1]),
                                                          np.int32)}}
    init = initial_state(model, frames[0])
    assert init["patch_embeddings"].shape == (1, 257, 128)
    rng = np.random.default_rng(3)
    raws = rng.standard_normal((12, 7)).astype(np.float32)
    raws[:, 6] = rng.random(12) > 0.5
    for setup in ("google_robot", "widowx_bridge", "libero"):
        policy = InferenceWrapper(model, policy_setup=setup, crop=True,
                                  image_size=224, action_ensemble=True,
                                  fused_serving=True)
        policy.reset("task", instruction, init)
        for frame in frames[:2]:
            raw, action, _, _, _ = policy.step(frame)
            assert raw.shape == action.shape == (7,)
            assert np.isfinite(action).all()
        policy.reset("task", instruction, init)
        jax_policy = JaxWrapper(model=None, policy_setup=setup)
        for raw in raws:
            np.testing.assert_allclose(policy._postprocess(raw),
                                       jax_policy._postprocess(raw),
                                       atol=1e-6)


def test_inference_wrapper_rejects_unported_options(fp32):
    """Attention-map capture, a history window (horizon > 1) and the
    padded resize run on the host path: as in the JAX wrapper, each turns
    the fused step off (the window's failure on the ViT base net, carried
    from the JAX package, is tests/test_torch_host_path.py::
    test_history_window_fails_as_in_jax; the captured maps are held to
    the JAX wrapper's in tests/test_torch_attention_capture.py)."""
    model = fp32[2]
    model.dataset_statistics = {"action": STATS}
    for kwargs in (dict(horizon=2), dict(padded_resize=True),
                   dict(save_attention_map=True)):
        assert not InferenceWrapper(model, fused_serving=True,
                                    **kwargs).fused_serving
