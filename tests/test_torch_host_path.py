"""The port's InferenceWrapper host path (fused_serving=False, the JAX
package's default) against the JAX wrapper's on the CPU, with the same
params (a tiny fp32 DINOv2 model, tests/test_torch_serving.py::_build) and
the same frames: resize (optionally padded to 256x320 first, and
centre-cropped), the image history, HyperVLA.sample_actions, host-side
unnormalisation and ensembling, the per-robot post-processing.

The resize and crop round to uint8, where a value at .5 may round either
way in the two packages: each tick holds the port's resized frame to
tests/test_torch_preprocess.py's bound (one level on at most 0.1% of the
pixels), then feeds both wrappers the JAX package's pixels and holds the
actions to 1e-5."""
import logging

import numpy as np
import pytest
import torch

from hypervla_tpu.eval.inference import InferenceWrapper as JaxWrapper
from hypervla_tpu.utils.static import static_dict
from hypervla_tpu_torch.configs import tiny_test_config
from hypervla_tpu_torch.eval.inference import InferenceWrapper
from hypervla_tpu_torch.flagship import make_flagship_batch
from hypervla_tpu_torch.models.hypervla import HyperVLA
from test_torch_preprocess import _assert_close_u8
from test_torch_serving import STATS, _build
from test_torch_harness import torch_threads  # noqa: F401

TICKS = 3
TRUNK = "encoder/image_encoder/trunk/"


def build_bf16(**hypernet_kwargs):
    """The port's tiny model on a bf16 DINOv2 trunk of head dim 64
    (`dinov2-test-wide`, the stacked trunk's shape), from seed 0, with
    hypernet_kwargs over tiny_test_config's and perturbed fan-out kernels
    (at init they are zero, and every task gets the same params). Returns
    (model, instruction, initial state)."""
    config = tiny_test_config(hypernet_kwargs=hypernet_kwargs)
    config["base_net_kwargs"]["vit_kwargs"].update(
        pretrained_encoder_name="dinov2-test-wide", encoder_dtype="bfloat16",
        sow_dino_attention=False)
    batch = make_flagship_batch(instr_len=8, action_horizon=2,
                                initial_patch_dim=128, seed=0)
    model = HyperVLA.from_config(config, batch, seed=0, device="cpu",
                                 dataset_statistics={"action": STATS})
    gen = torch.Generator().manual_seed(0)
    model.params = {
        k: v + 0.02 * torch.randn(v.shape, generator=gen)
        if k.startswith("output_head_") and k.endswith("kernel") else v
        for k, v in model.params.items()}
    instruction = {"language_instruction":
                   batch["task"]["language_instruction"]}
    return model, instruction, {k: np.asarray(v)
                                for k, v in batch["initial_state"].items()}


@pytest.fixture(scope="module")
def fp32():
    jmodel, _, model, _, _, tok = _build({}, 32)
    frames = np.random.default_rng(8).integers(0, 256, (TICKS, 200, 300, 3),
                                               dtype=np.uint8)
    example = model.example_batch
    instruction = {"language_instruction":
                   example["task"]["language_instruction"]}
    return jmodel, model, instruction, example["initial_state"], frames


def _with_stats(jmodel, model, stats):
    return (jmodel.replace(dataset_statistics=static_dict(stats)),
            model.replace(dataset_statistics=stats))


def step_both(jwrapper, wrapper, frame):
    """One tick of each wrapper on `frame`: the resized frames to the uint8
    bound, then the port's tick from the JAX package's pixels. Returns
    ((raw, action) of the JAX wrapper, the same of the port's)."""
    jax_image = jwrapper._resize_image(frame)
    _assert_close_u8(wrapper._resize_image(frame), jax_image)
    wrapper._resize_image = lambda _: jax_image
    try:
        raw_j, act_j, img_j, _, _ = jwrapper.step(frame)
        raw, act, img, _, _ = wrapper.step(frame)
    finally:
        del wrapper._resize_image
    np.testing.assert_array_equal(img, img_j)
    return (raw_j, act_j), (raw, act)


@pytest.mark.parametrize("padded_resize", [False, True])
@pytest.mark.parametrize("crop", [False, True])
def test_host_step_matches_jax(fp32, padded_resize, crop):
    jmodel, model, instruction, init, frames = fp32
    jmodel, model = _with_stats(jmodel, model, {"action": STATS})
    kwargs = dict(policy_setup="libero", pred_action_horizon=2,
                  image_size=224, action_ensemble=True, crop=crop,
                  padded_resize=padded_resize)
    jwrapper = JaxWrapper(model=jmodel, **kwargs)
    wrapper = InferenceWrapper(model, **kwargs)
    assert not wrapper.fused_serving and wrapper.trunk_impl == "kernel"
    for w in (jwrapper, wrapper):
        w.reset("pick up the cube", instruction, init)
    for frame in frames:
        ref, got = step_both(jwrapper, wrapper, frame)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, atol=1e-5)
    assert wrapper.episode_step == TICKS and len(wrapper.image_history) == 1


@pytest.mark.parametrize("crop", [False, True])
def test_fused_step_matches_host_step(fp32, crop):
    """The port's fused step against its host path, at the 1e-4 the JAX
    package holds between its own two paths
    (tests/test_serving.py::test_inference_wrapper_fused_matches_host_path)."""
    _, model, instruction, init, frames = fp32
    model = model.replace(dataset_statistics={"action": STATS})
    kwargs = dict(policy_setup="libero", pred_action_horizon=2,
                  image_size=224, action_ensemble=True, crop=crop)
    host = InferenceWrapper(model, **kwargs)
    fused = InferenceWrapper(model, **kwargs, fused_serving=True)
    assert fused.fused_serving and not host.fused_serving
    for w in (host, fused):
        w.reset("pick up the cube", instruction, init)
    for frame in frames:
        raw_h, act_h, _, _, _ = host.step(frame)
        raw_f, act_f, _, _, _ = fused.step(frame)
        np.testing.assert_allclose(raw_f, raw_h, atol=1e-4)
        np.testing.assert_allclose(act_f, act_h, atol=1e-4)


def test_padded_resize_takes_the_host_path(fp32):
    """As in the JAX wrapper, fused_serving with padded_resize serves the
    host path (the fused step has no padded resize), on the trunk asked
    for."""
    _, model, _, _, _ = fp32
    model = model.replace(dataset_statistics={"action": STATS})
    wrapper = InferenceWrapper(model, padded_resize=True, fused_serving=True,
                               trunk_impl="reference")
    assert not wrapper.fused_serving
    assert wrapper.trunk_impl == "reference"


@pytest.mark.parametrize("trunk_impl", ["kernel", "layers"])
def test_host_path_runs_the_trunk_asked_for(trunk_impl):
    """On a bf16 trunk the host path runs trunk_impl's trunk: "kernel" over
    the stacked trunk params (kernel 1, dino_layers_serving, on the card),
    "layers" over the per-layer leaves. Its actions match the fused step on
    the same trunk to the 1e-4 of test_fused_step_matches_host_step."""
    model, instruction, init = build_bf16()
    kwargs = dict(policy_setup="libero", pred_action_horizon=2,
                  image_size=224, action_ensemble=True, crop=True,
                  trunk_impl=trunk_impl)
    host = InferenceWrapper(model, **kwargs)
    fused = InferenceWrapper(model, fused_serving=True, **kwargs)
    for w in (host, fused):
        w.reset("pick up the cube", instruction, init)
    stacked = any(k.startswith(TRUNK) for k in host.base_params)
    assert stacked == (trunk_impl == "kernel")
    frames = np.random.default_rng(9).integers(0, 256, (TICKS, 256, 256, 3),
                                               dtype=np.uint8)
    for frame in frames:
        raw_h, act_h, _, _, _ = host.step(frame)
        raw_f, act_f, _, _, _ = fused.step(frame)
        np.testing.assert_allclose(raw_h, raw_f, atol=1e-4)
        np.testing.assert_allclose(act_h, act_f, atol=1e-4)


def test_exec_horizon_is_refused(fp32):
    """A step returns one action: an exec_horizon other than 1 raises;
    init_rng is taken and changes nothing on this mix-head model (its
    decode is not random; tests/test_torch_diffusion_head.py holds the
    diffusion head's)."""
    _, model, instruction, init, frames = fp32
    model = model.replace(dataset_statistics={"action": STATS})
    with pytest.raises(ValueError, match="exec_horizon=4"):
        InferenceWrapper(model, exec_horizon=4)
    actions = []
    for init_rng in (0, 7):
        w = InferenceWrapper(model, policy_setup="libero",
                             pred_action_horizon=2, image_size=224,
                             init_rng=init_rng)
        w.reset("pick up the cube", instruction, init)
        actions.append(w.step(frames[0])[0])
    np.testing.assert_array_equal(*actions)


@pytest.mark.parametrize("fused", [False, True])
def test_history_window_fails_as_in_jax(fp32, fused):
    """horizon=2, as the JAX wrapper runs it: the host path (the fused step
    takes no history), whose first step sees one frame and runs, and whose
    second hands the ViT base net a window of two frames, which raises
    ValueError in both packages."""
    jmodel, model, instruction, init, frames = fp32
    jmodel, model = _with_stats(jmodel, model, {"action": STATS})
    kwargs = dict(policy_setup="libero", pred_action_horizon=2, horizon=2,
                  image_size=224, fused_serving=fused)
    jwrapper = JaxWrapper(model=jmodel, **kwargs)
    wrapper = InferenceWrapper(model, **kwargs)
    assert not wrapper.fused_serving and not jwrapper.fused_serving
    for w in (jwrapper, wrapper):
        w.reset("pick up the cube", instruction, init)
    ref, got = step_both(jwrapper, wrapper, frames[0])
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=1e-5)
    for w in (jwrapper, wrapper):
        with pytest.raises(ValueError):
            w.step(frames[1])


def test_statistics_fall_back_to_the_first_dataset(fp32, caplog):
    """Statistics of one dataset only, served under another policy setup:
    both wrappers warn and unnormalise with the first dataset's (in sorted
    order), and the actions agree."""
    jmodel, model, instruction, init, frames = fp32
    stats = {"fractal20220817_data": {"action": STATS},
             "libero": {"action": {"mean": np.zeros(7), "std": np.ones(7)}}}
    jmodel, model = _with_stats(jmodel, model, stats)
    kwargs = dict(policy_setup="widowx_bridge", pred_action_horizon=2,
                  image_size=224, action_ensemble=False)
    with caplog.at_level(logging.WARNING):
        wrapper = InferenceWrapper(model, **kwargs)
    assert "falling back to fractal20220817_data" in caplog.text
    assert wrapper.unnormalization_statistics is STATS
    jwrapper = JaxWrapper(model=jmodel, **kwargs)
    for w in (jwrapper, wrapper):
        w.reset("pick up the cube", instruction, init)
    for frame in frames[:2]:
        ref, got = step_both(jwrapper, wrapper, frame)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, atol=1e-5)


def test_missing_statistics_raise_where_actions_are_unnormalised(fp32):
    """A model without statistics builds a wrapper, as in the JAX package;
    the host path raises at its first step, the fused path when its step is
    built at reset."""
    jmodel, model, instruction, init, frames = fp32
    jmodel, model = _with_stats(jmodel, model, None)
    JaxWrapper(model=jmodel, policy_setup="libero")
    host = InferenceWrapper(model, policy_setup="libero",
                            pred_action_horizon=2, image_size=224)
    host.reset("pick up the cube", instruction, init)
    with pytest.raises(ValueError, match="no dataset statistics"):
        host.step(frames[0])
    fused = InferenceWrapper(model, policy_setup="libero", fused_serving=True)
    with pytest.raises(ValueError, match="no dataset statistics"):
        fused.reset("pick up the cube", instruction, init)
