"""A checkpoint of the JAX package's tiny DINOv2 model with the diffusion
head (the score network at hidden_dim 32 and 2 blocks), saved by its
save_pretrained with an EMA_params.pkl, converted by
tools/convert_checkpoint_to_torch.py and loaded by both packages'
load_hypervla_policy on the CPU: the score network's stacked blocks and
their fan-out heads carried under the JAX keys, and three host-path ticks
(the JAX defaults: google_robot, crop, ensembling) serving the same
actions to 1e-5, the port's ticks given the draws of the JAX wrapper's
per-tick keys (tests/test_torch_diffusion_head.py::sampler_draws) and the
JAX wrapper's resized pixels (tests/test_torch_host_path.py::step_both
says why)."""
import os
import pickle

import jax
import numpy as np
import torch

from helpers import make_example_batch
from hypervla_tpu.configs import tiny_test_config as jax_tiny_config
from hypervla_tpu.eval.model_loading import (
    load_hypervla_policy as jax_load_policy,
)
from hypervla_tpu.models.hypervla import HyperVLA as JaxHyperVLA
from hypervla_tpu_torch.eval.model_loading import load_hypervla_policy
from hypervla_tpu_torch.models.draws import Draws
from hypervla_tpu_torch.utils.convert import from_jax_params
from test_torch_checkpoint import STATS, _perturb_heads
from test_torch_diffusion_head import HEAD, sampler_draws
from test_torch_preprocess import _assert_close_u8
from tools.convert_checkpoint_to_torch import convert
from test_torch_harness import torch_threads  # noqa: F401

TICKS = 3
STEP = 7


def test_converted_diffusion_checkpoint_serves_as_jax(tmp_path):
    batch = make_example_batch(image_size=224, initial_image=True,
                               initial_patch_dim=32, seed=2)
    config = jax_tiny_config("DINOv2", action_head_type="diffusion")
    config["base_net_kwargs"]["action_head_kwargs"].update(HEAD)
    jmodel = JaxHyperVLA.from_config(config, batch, jax.random.PRNGKey(0),
                                     dataset_statistics=STATS)
    params = _perturb_heads(jmodel.params, 0, 0.02)
    jmodel = jmodel.replace(params=params)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jmodel.save_pretrained(step=STEP, checkpoint_path=jdir)
    ema = _perturb_heads(params, 1, 0.01)
    with open(os.path.join(jdir, str(STEP), "EMA_params.pkl"), "wb") as f:
        pickle.dump({"EMA_0.999": ema}, f)
    assert convert(jdir, tdir) == [STEP]

    jpolicy = jax_load_policy(jdir)
    policy = load_hypervla_policy(tdir, device="cpu")
    want = from_jax_params(ema)
    assert set(policy.model.params) == set(want)
    for name, value in want.items():
        assert torch.equal(policy.model.params[name], value), name
    fan_out = ("output_head_action_head_diffusion_model_trunk_blocks_"
               "Dense_0_kernel/kernel")
    assert tuple(policy.model.params[fan_out].shape) == (16, 2 * 32 * 128)

    example = jax.tree_util.tree_map(lambda x: np.asarray(x)[:1], batch)
    instruction = {"language_instruction":
                   example["task"]["language_instruction"]}
    for w in (jpolicy, policy):
        w.reset("pick up the cube", instruction, example["initial_state"])
    frames = np.random.default_rng(5).integers(
        0, 256, (TICKS, 256, 256, 3), dtype=np.uint8)
    for frame in frames:
        jax_image = jpolicy._resize_image(frame)
        _assert_close_u8(policy._resize_image(frame), jax_image)
        policy._resize_image = lambda _: jax_image
        _, key = jax.random.split(jpolicy.rng)  # this tick's key
        raw_j, act_j, _, _, _ = jpolicy.step(frame)
        raw, act, _, _, _ = policy.step(frame, rng=Draws(
            replay=sampler_draws(key, (1, 1, 14))))
        del policy._resize_image
        np.testing.assert_allclose(raw, np.asarray(raw_j), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(act, np.asarray(act_j), rtol=1e-5,
                                   atol=1e-5)
