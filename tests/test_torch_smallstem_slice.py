"""The SmallStem HyperVLA in the port (a policy ViT over a generated,
weight-standardized conv stem; the "block" and "full" generation
strategies; the mix and the continuous heads) against the JAX package on
the CPU, at the JAX tiny config's size (64-px frames, 32-channel stem,
16-wide ViT), fp32 to 1e-5, inputs from a numpy seed:

  * the weight plan, create_tasks' generated weights and sample_actions'
    action chunk, from the same hypernet params with perturbed fan-out
    kernels (at init they are zero, and every task gets the same weights);
  * InferenceWrapper steps, host path, against the JAX wrapper, and the
    port's fused step against its host path;
  * a checkpoint round trip through save_pretrained, the EMA file and
    load_hypervla_policy;
  * the published vit_t config with the two command-line overrides
    (model_type=vit, action_head_type=continuous): its plan against the
    JAX package's at 224 px, and two trainer steps through train.main.main
    with that config's overrides on a tiny SmallStem config file.

The one-step train parity is tests/test_torch_smallstem_train_step.py
(its own file, so that its JAX compiles run on another test worker).

The JAX ContinuousActionHead takes every action_head_kwargs key as a field
and raises on the keys of the other heads that the JAX configs carry
(hidden_dims, discrete_token_type, ...), so its configs here keep the
continuous head's keys, as tests/test_reference_parity.py does; the port's
head reads only its own.
"""
import io
import os

import flax
import jax
import numpy as np
import pytest
import torch

from helpers import make_example_batch
from hypervla_tpu.configs import pretrain_config as jax_pretrain_config
from hypervla_tpu.configs import tiny_test_config as jax_tiny_config
from hypervla_tpu.data.sources import NpzTrajectorySource
from hypervla_tpu.eval.inference import InferenceWrapper as JaxWrapper
from hypervla_tpu.models.hypervla import HyperVLA as JaxHyperVLA
from hypervla_tpu.models.weight_plan import init_base_net as jax_plan
from hypervla_tpu.utils.static import static_dict
from hypervla_tpu_torch.configs import tiny_test_config
from hypervla_tpu_torch.eval.inference import InferenceWrapper
from hypervla_tpu_torch.eval.model_loading import load_hypervla_policy
from hypervla_tpu_torch.models.base_network import BaseNetwork
from hypervla_tpu_torch.models.hypervla import (
    EMA_FILE,
    HyperVLA,
    _unflatten,
    save_ema_params,
)
from hypervla_tpu_torch.models.weight_plan import build_weight_plan
from hypervla_tpu_torch.train.main import apply_overrides, load_config, main
from hypervla_tpu_torch.utils.convert import flatten_tree, from_jax_params
from test_torch_host_path import step_both
from test_torch_serving import STATS
from test_torch_harness import torch_threads  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
SIZE = 64
#: the two command-line overrides that make the published vit_t config a
#: SmallStem ViT with the continuous head
OVERRIDES = ["--config.base_net_kwargs.model_type=vit",
             "--config.base_net_kwargs.action_head_type=continuous"]
CONTINUOUS_KEYS = ("max_action", "loss_type", "token_per_horizon",
                   "squash_continuous_action", "tanh_scaling_factor",
                   "clip_target")
#: (generation_strategy, action_head_type) of the parity cases
CASES = [("block", "mix"), ("full", "continuous"), ("full", "mix")]


def jax_config(strategy, head, **hypernet_kwargs):
    """The JAX tiny SmallStem config (see the module docstring for the
    continuous head's keys)."""
    config = jax_tiny_config(
        "SmallStem", action_head_type=head,
        hypernet_kwargs=dict(generation_strategy=strategy,
                             **hypernet_kwargs))
    if head == "continuous":
        kw = config["base_net_kwargs"]["action_head_kwargs"]
        config["base_net_kwargs"]["action_head_kwargs"] = {
            k: v for k, v in kw.items() if k in CONTINUOUS_KEYS}
    return config


def port_config(strategy, head, **hypernet_kwargs):
    return tiny_test_config(
        "SmallStem", action_head_type=head,
        hypernet_kwargs=dict(generation_strategy=strategy,
                             **hypernet_kwargs))


def perturbed_kernels(params, seed=0):
    """A flat param dict with N(0, 0.02) added to the fan-out kernels."""
    rng = np.random.RandomState(seed)
    return {k: (v + rng.randn(*v.shape).astype(np.float32) * 0.02
                if k.startswith("output_head") and k.endswith("kernel")
                else v) for k, v in params.items()}


def build_pair(strategy, head, batch_size=1, stats=None):
    """(JAX model, the port's model on the same params, example batch)."""
    batch = make_example_batch(batch_size=batch_size, image_size=SIZE)
    jmodel = JaxHyperVLA.from_config(jax_config(strategy, head), batch,
                                     jax.random.PRNGKey(0))
    flat = perturbed_kernels(flatten_tree(jax.tree_util.tree_map(
        np.asarray, flax.core.unfreeze(jmodel.params))))
    jmodel = jmodel.replace(params=_unflatten(flat))
    model = HyperVLA.from_config(port_config(strategy, head), batch,
                                 device="cpu")
    params = from_jax_params(jmodel.params)
    assert set(params) == set(model.params)
    for name, value in params.items():
        assert value.shape == model.params[name].shape, name
    model.params = params
    if stats is not None:
        jmodel = jmodel.replace(dataset_statistics=static_dict(stats))
        model = model.replace(dataset_statistics=stats)
    return jmodel, model, batch


def _instruction(batch):
    return {"language_instruction": batch["task"]["language_instruction"]}


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "-".join(c))
def pair(request):
    return request.param, build_pair(*request.param, stats={"action": STATS})


def test_plan_matches_jax(pair):
    """Token indices, the layer-token mask, shapes and generation flags of
    the port's plan against the JAX package's metadata."""
    (strategy, head), (jmodel, model, _) = pair
    md = jmodel.base_net_metadata
    flat = flatten_tree(jax.tree_util.tree_map(
        lambda x: x, flax.core.unfreeze(md["token_index_dict"])))
    plan = model.plan
    assert plan.names == sorted(flat, key=lambda n: tuple(n.split("/")))
    assert plan.token_index == flat
    assert plan.layer_token_mask == md["layer_token_mask"]
    assert plan.total_param_num == md["total_param_num"]
    shapes = flatten_tree(flax.core.unfreeze(md["param_shape"]))
    assert {n: tuple(s) for n, s in shapes.items()} == plan.param_shape
    assert model.hypernet.layer_token_num == (
        1 if strategy == "full" else md["block_num"])
    assert any("SmallStem_0/StdConv_0" in n for n in plan.names)
    assert all(plan.generation_flag.values())


def test_create_tasks_and_sample_actions_match_jax(pair):
    (_, head), (jmodel, model, batch) = pair
    instruction = _instruction(batch)
    jparams, jtasks, _ = jmodel.create_tasks(instruction_dict=instruction)
    base_params, tasks = model.create_tasks(instruction_dict=instruction)
    ref = flatten_tree(flax.core.unfreeze(jax.device_get(jparams)))
    assert set(ref) == set(base_params)
    for name, value in ref.items():
        assert base_params[name].shape == value.shape, name
        np.testing.assert_allclose(base_params[name].numpy(),
                                   np.asarray(value), err_msg=name, **TOL)
    images = batch["observation"]["image_primary"]
    ref_action, _ = jmodel.sample_actions(
        images, instruction, jtasks, batch["observation"]["timestep_pad_mask"],
        jparams, rng=jax.random.PRNGKey(0))
    action = model.sample_actions(images, instruction, tasks, None,
                                  base_params)
    assert action.shape == (1, 2, 7)
    np.testing.assert_allclose(action.numpy(), np.asarray(ref_action), **TOL)
    if head == "mix":
        assert set(np.unique(action[..., -1].numpy())) <= {0.0, 1.0}


@pytest.mark.parametrize("crop", [False, True])
def test_inference_wrapper_matches_jax(pair, crop):
    """The host path against the JAX wrapper's (resized pixels to the
    uint8 bound, actions to 1e-5 from the JAX pixels), and the fused step
    against the host path, at the 1e-4 the JAX package holds between its
    two paths."""
    _, (jmodel, model, batch) = pair
    kwargs = dict(policy_setup="libero", pred_action_horizon=2,
                  image_size=SIZE, action_ensemble=True, crop=crop)
    jwrapper = JaxWrapper(model=jmodel, **kwargs)
    wrapper = InferenceWrapper(model, **kwargs)
    fused = InferenceWrapper(model, fused_serving=True, **kwargs)
    assert wrapper.trunk_impl is None and fused.fused_serving
    for w in (jwrapper, wrapper, fused):
        w.reset("pick up the cube", _instruction(batch))
    frames = np.random.default_rng(3).integers(0, 256, (3, 80, 96, 3),
                                               dtype=np.uint8)
    for frame in frames:
        ref, got = step_both(jwrapper, wrapper, frame)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, atol=1e-5)
        raw_f, act_f, _, _, _ = fused.step(frame)
        np.testing.assert_allclose(raw_f, got[0], atol=1e-4)
        np.testing.assert_allclose(act_f, got[1], atol=1e-4)


def test_trunk_impls_are_refused_without_a_trunk(pair):
    """The stacked trunk impls are DINOv2-only in the JAX package
    (ops/serving.py::make_pallas_trunk_net asserts it): a model with a
    generated stem takes trunk_impl None only."""
    _, (_, model, _) = pair
    for impl in ("kernel", "reference", "layers"):
        with pytest.raises(ValueError, match="DINOv2-only"):
            InferenceWrapper(model, policy_setup="libero", trunk_impl=impl)


def test_history_window_fails_in_both(pair):
    """A window of two frames on the generated stem: the first step (one
    frame in the history) runs in both packages, the second raises
    ValueError in both."""
    _, (jmodel, model, batch) = pair
    kwargs = dict(policy_setup="libero", horizon=2, pred_action_horizon=2,
                  image_size=SIZE)
    jwrapper = JaxWrapper(model=jmodel, **kwargs)
    wrapper = InferenceWrapper(model, **kwargs)
    frame = np.random.default_rng(7).integers(0, 256, (SIZE, SIZE, 3),
                                              dtype=np.uint8)
    for w in (jwrapper, wrapper):
        w.reset("pick up the cube", _instruction(batch))
    ref, got = step_both(jwrapper, wrapper, frame)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=1e-5)
    for w in (jwrapper, wrapper):
        with pytest.raises(ValueError):
            w.step(frame)


def test_checkpoint_round_trip(pair, tmp_path):
    """save_pretrained, an EMA file of other params, load_hypervla_policy:
    the loaded model's plan and params are the saved ones, and the served
    actions are those of the EMA params."""
    _, (_, model, batch) = pair
    model.save_pretrained(5, str(tmp_path))
    ema = {k: v * 0.5 for k, v in model.params.items()}
    save_ema_params(str(tmp_path), 5, ema)
    loaded = HyperVLA.load_pretrained(str(tmp_path), device="cpu")
    assert loaded.plan == model.plan
    for name, value in model.params.items():
        assert torch.equal(loaded.params[name], value), name
    kwargs = dict(policy_setup="libero", image_size=SIZE, crop=False,
                  action_ensemble=False)
    policy = load_hypervla_policy(str(tmp_path), device="cpu", **kwargs)
    reference = InferenceWrapper(model.replace(params=ema),
                                 pred_action_horizon=2, **kwargs)
    frame = np.random.default_rng(4).integers(0, 256, (SIZE, SIZE, 3),
                                              dtype=np.uint8)
    for name, value in ema.items():
        assert torch.equal(policy.model.params[name], value), name
    for w in (policy, reference):
        w.reset("pick up the cube", _instruction(batch))
    # the statistics come back from JSON in float64
    np.testing.assert_allclose(policy.step(frame)[0],
                               reference.step(frame)[0], rtol=1e-6)
    assert os.path.exists(tmp_path / "5" / EMA_FILE)


def _vit_t_config():
    config = load_config("vit_t,fixture")
    apply_overrides(config, list(OVERRIDES))
    return config


def test_vit_t_smallstem_config_plan_matches_jax():
    """The published vit_t config with the two overrides: the generated
    SmallStem (32, 96, 192, 384) at 224 px, the "full" strategy, a 1-layer
    128-wide context encoder; its plan is the JAX package's (1.03 M
    generated base-net params a task)."""
    config = _vit_t_config()
    vk = config["base_net_kwargs"]["vit_kwargs"]
    assert vk["encoder_type"] == "SmallStem" and vk["patch_size"] == 16
    assert tuple(vk["cnn_channels"]) == (32, 96, 192, 384)
    hk = config["hypernet_kwargs"]
    assert hk["generation_strategy"] == "full" and not hk["shared_modules"]
    assert hk["context_embedding_dim"] == 128
    assert hk["context_encoder_kwargs"]["num_layers"] == 1
    batch = make_example_batch(image_size=224)
    plan = build_weight_plan(config, BaseNetwork(
        **config["base_net_kwargs"],
        input_shapes={"image": (224, 224)}))
    jconfig = jax_pretrain_config("vit_t")
    jconfig["base_net_kwargs"].update(model_type="vit",
                                      action_head_type="continuous")
    kw = jconfig["base_net_kwargs"]["action_head_kwargs"]
    jconfig["base_net_kwargs"]["action_head_kwargs"] = {
        k: v for k, v in kw.items() if k in CONTINUOUS_KEYS}
    _, _, flat, md = jax_plan(jconfig, batch, jax.random.PRNGKey(0))
    assert plan.total_param_num == md["total_param_num"] == flat.shape[0]
    assert 1.0e6 < plan.total_param_num < 1.1e6
    shapes = flatten_tree(flax.core.unfreeze(md["param_shape"]))
    assert {n: tuple(s) for n, s in shapes.items()} == plan.param_shape
    assert plan.layer_token_mask == md["layer_token_mask"]


def _jpeg(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG")
    return buf.getvalue()


def test_trainer_command_line_trains_and_serves(tmp_path):
    """Two steps of train.main.main on a config file of the tiny SmallStem
    config (64-px fixture frames, "full" generation), with the vit_t
    overrides on the command line; the checkpoint then serves."""
    data = tmp_path / "data" / "fixture_train"
    os.makedirs(data)
    rng = np.random.RandomState(0)
    for ep in range(2):
        NpzTrajectorySource.write_trajectory(
            str(data / f"ep_{ep:03d}.npz"),
            {"observation": {"image": np.array(
                [_jpeg(rng.randint(0, 255, (SIZE, SIZE, 3)).astype(np.uint8))
                 for _ in range(6)], dtype=object)},
             "action": rng.randn(6, 7).astype(np.float32),
             "language_instruction": np.array([b"close top drawer"] * 6,
                                              dtype=object)})
    config = port_config("full", "mix")
    config["base_net_kwargs"]["model_type"] = "cnn"
    config["dataset_kwargs"] = {
        "batch_size": 4, "shuffle_buffer_size": 8,
        "text_tokenizer": "t5-base", "tokenizer_max_length": 8,
        "resize_size": {"primary": (SIZE, SIZE)},
        "dataset_kwargs_list": [dict(
            name="fixture_train", data_dir=str(tmp_path / "data"),
            image_obs_keys={"primary": "image"},
            language_key="language_instruction",
            action_proprio_normalization_type="normal")]}
    config.update(log_interval=1, save_interval=1000, save_param_EMA=True,
                  EMA_start_step=0, seed=3)
    path = tmp_path / "config.py"
    path.write_text(f"def get_config(s):\n    return {config!r}\n")
    save_dir = str(tmp_path / "run")
    state = main(["--config", f"{path}:x", "--save_dir", save_dir, "--cpu",
                  "--config.num_steps=2"] + OVERRIDES)
    assert state.step == 2
    for name, p in state.params.items():
        assert torch.isfinite(p).all(), name
    policy = load_hypervla_policy(save_dir, image_size=SIZE, crop=False,
                                  policy_setup="libero", device="cpu")
    assert policy.model.config["base_net_kwargs"]["action_head_type"] == (
        "continuous")
    ids = np.arange(8, dtype=np.int32)[None]
    emb = np.random.default_rng(5).standard_normal((1, 8, 768)).astype(
        np.float32)
    policy.reset("close top drawer", {"language_instruction": {
        "input_ids": ids, "attention_mask": np.ones_like(ids),
        "token_embedding": emb}})
    frame = np.random.default_rng(6).integers(0, 256, (SIZE, SIZE, 3),
                                              dtype=np.uint8)
    for _ in range(2):
        _, action, *_ = policy.step(frame)
        assert action.shape == (7,) and np.isfinite(action).all()
