"""The port's diffusion action head (hypervla_tpu_torch/models/
diffusion.py, models/action_heads.py::DiffusionActionHead) against the
JAX package's on the CPU in fp32, on the same params (the JAX init,
perturbed, through utils/convert.py::from_jax_params) and inputs, with the
JAX draws passed in: the cosine schedule, the score network alone, the
20-step predict_action, HyperVLA.sample_actions on the tiny DINOv2 twin
(`tiny_test_config("DINOv2", action_head_type="diffusion")`, the head at
hidden_dim 32 and 2 blocks) and five fused InferenceWrapper ticks with
the JAX wrapper's per-tick keys, each to 1e-5.

The JAX sampler draws x_T from split(rng)[1] and each step's noise from a
split chain (hypervla_tpu/models/action_heads.py:537-557); `sampler_draws`
computes them from the rng outside the sampler and hands them to the port
by site. Also: a diffusion-head checkpoint saved and loaded by the port,
the generator-driven sampler's repeatability, the head's refusal to
sample without an rng, and the K-tick and multi-task steps handing their
ticks the rng.
"""
import copy

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import make_example_batch
from hypervla_tpu.configs import tiny_test_config as jax_tiny_config
from hypervla_tpu.eval.inference import InferenceWrapper as JaxWrapper
from hypervla_tpu.models import action_heads as jah
from hypervla_tpu.models.hypervla import HyperVLA as JaxHyperVLA
from hypervla_tpu.models.token_group import TokenGroup
from hypervla_tpu.utils.static import static_dict
from hypervla_tpu_torch.configs import tiny_test_config
from hypervla_tpu_torch.eval.inference import InferenceWrapper
from hypervla_tpu_torch.models import action_heads as ah
from hypervla_tpu_torch.models.draws import Draws
from hypervla_tpu_torch.models.hypervla import HyperVLA
from hypervla_tpu_torch.utils.convert import flatten_tree, from_jax_params
from test_torch_harness import torch_threads  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
HORIZON, DIM, EMB = 2, 7, 16
#: the tiny score network of the CPU tests (the flagship's is 256 x 3)
HEAD = dict(hidden_dim=32, num_blocks=2)
STEPS = 20
TICKS = 5
STATS = {
    "mean": np.arange(7, dtype=np.float32) / 10,
    "std": 1 + np.arange(7, dtype=np.float32) / 7,
    "mask": np.array([True] * 6 + [False]),
}


def sampler_draws(rng, shape, steps=STEPS):
    """{port site: draw} of the JAX head's sampler on `rng`: x_T from the
    second half of its split, then one normal a step down the chain of the
    first half."""
    rng, key = jax.random.split(rng)
    out = {"action_head/x_T": np.asarray(jax.random.normal(key, shape))}
    for t in range(steps - 1, -1, -1):
        rng, key = jax.random.split(rng)
        out[f"action_head/z/{t}"] = np.asarray(jax.random.normal(key, shape))
    return out


def _perturbed(tree, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + rng.standard_normal(np.shape(v))
                   * scale).astype(np.float32), tree)


def test_schedule_matches_jax():
    """betas, alphas and alpha_bars of the 20-step cosine schedule, fp32
    bit for bit (the cumulative product included)."""
    ref = jah.DDPMSchedule.cosine(STEPS)
    got = ah.DDPMSchedule.cosine(STEPS)
    for name in ("betas", "alphas", "alpha_bars"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert float(got.betas[-1]) == np.float32(0.999)


@pytest.fixture(scope="module")
def heads():
    """The JAX head on perturbed init params and the port's on the same,
    for readout tokens (3, 1, 1, EMB)."""
    jhead = jah.DiffusionActionHead(readout_key="readout_action",
                                    action_dim=DIM, action_horizon=HORIZON,
                                    **HEAD)
    rng = np.random.default_rng(1)
    tokens = rng.standard_normal((3, 1, 1, EMB)).astype(np.float32)
    outputs = {"readout_action": TokenGroup(jnp.asarray(tokens), None)}
    variables = _perturbed(flax.core.unfreeze(jhead.init(
        jax.random.PRNGKey(0), outputs, train=False)))
    head = ah.DiffusionActionHead(HORIZON, DIM, **HEAD)
    params = {f"action_head/{k}": v for k, v in from_jax_params(
        variables["params"]).items()}
    assert set(params) == set(head.specs(EMB))
    for name, (shape, _) in head.specs(EMB).items():
        assert tuple(params[name].shape) == tuple(shape), name
    return jhead, variables, outputs, head, params, tokens


def test_score_network_matches_jax(heads):
    jhead, variables, outputs, head, params, tokens = heads
    rng = np.random.default_rng(2)
    time = rng.integers(0, STEPS, (3, 1, 1)).astype(np.int32)
    noisy = rng.standard_normal((3, 1, HORIZON * DIM)).astype(np.float32)
    ref = jhead.apply(variables, outputs, time=time, noisy_actions=noisy,
                      train=False)
    got = head(params, torch.tensor(tokens), torch.tensor(time),
               torch.tensor(noisy))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("seed", [0, 5])
def test_predict_action_matches_jax(heads, seed):
    """The 20 denoising steps, each result clipped to +-5, from the JAX
    draws."""
    jhead, variables, outputs, head, params, tokens = heads
    key = jax.random.PRNGKey(seed)
    ref = jhead.apply(variables, outputs, rng=key, train=False,
                      method="predict_action")
    draws = Draws(replay=sampler_draws(key, (3, 1, HORIZON * DIM)))
    got = head.predict_action(params, torch.tensor(tokens), draws)
    assert got.shape == (3, HORIZON, DIM)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # some actions lie inside the clip, so the comparison reads the
    # denoising arithmetic and not only the clip
    assert (np.abs(np.asarray(ref)) < 4.99).any()


def test_embodiment_mask_keeps_the_noise_past_the_embodiment(heads):
    jhead, variables, outputs, head, params, tokens = heads
    key = jax.random.PRNGKey(3)
    ref = jhead.apply(variables, outputs, rng=key, train=False,
                      embodiment_action_dim=5, method="predict_action")
    draws = Draws(replay=sampler_draws(key, (3, 1, HORIZON * DIM)))
    got = head.predict_action(params, torch.tensor(tokens), draws,
                              embodiment_action_dim=5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_predict_action_needs_an_rng_and_repeats_under_a_seed(heads):
    _, _, _, head, params, tokens = heads
    with pytest.raises(ValueError, match="rng"):
        head.predict_action(params, torch.tensor(tokens))

    def sample(seed):
        return head.predict_action(params, torch.tensor(tokens), Draws(
            torch.Generator().manual_seed(seed)))

    assert torch.equal(sample(4), sample(4))
    assert not torch.equal(sample(4), sample(5))


def _configs():
    jconfig = jax_tiny_config("DINOv2", action_head_type="diffusion")
    config = tiny_test_config(action_head_type="diffusion")
    for c in (jconfig, config):
        c["base_net_kwargs"]["action_head_kwargs"].update(HEAD)
    return jconfig, config


@pytest.fixture(scope="module")
def pair():
    """The JAX tiny DINOv2 twin with the diffusion head (fan-out kernels
    perturbed, so that tasks differ) and the port's on the same params,
    with dataset statistics, and both episodes' base params."""
    jconfig, config = _configs()
    batch = make_example_batch(image_size=224, initial_image=True,
                               initial_patch_dim=32, seed=2)
    jmodel = JaxHyperVLA.from_config(jconfig, batch, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(np.asarray, jmodel.params)
    for name, head in params.items():
        if name.startswith("output_head_"):
            head["kernel"] = head["kernel"] + 0.02 * rng.standard_normal(
                head["kernel"].shape).astype(np.float32)
    jmodel = jmodel.replace(params=params,
                            dataset_statistics=static_dict({"action": STATS}))
    example = jax.tree_util.tree_map(lambda x: np.asarray(x)[:1], batch)
    instruction = {"language_instruction":
                   example["task"]["language_instruction"]}
    jbase, jtasks, _ = jmodel.create_tasks(
        instruction_dict=instruction, initial_state=example["initial_state"])
    model = HyperVLA.from_config(config, example, device="cpu",
                                 dataset_statistics={"action": STATS})
    model.params = from_jax_params(params)
    base, tasks = model.create_tasks(
        instruction_dict=instruction, initial_state=example["initial_state"])
    ref = flatten_tree(flax.core.unfreeze(jax.device_get(jbase)))
    assert set(ref) == set(base)
    return jmodel, jbase, jtasks, model, base, tasks, example, instruction


def test_create_tasks_generates_the_stacked_blocks(pair):
    """The generated score network, its blocks stacked on the depth axis
    under the JAX keys, equals the JAX hypernetwork's."""
    jmodel, jbase, _, model, base, _, _, _ = pair
    ref = flatten_tree(flax.core.unfreeze(jax.device_get(jbase)))
    name = "action_head/diffusion_model/trunk/blocks/Dense_0/kernel"
    assert tuple(base[name].shape) == (2, 32, 128)
    for key, value in ref.items():
        if key.startswith("action_head"):
            np.testing.assert_allclose(base[key].numpy(), np.asarray(value),
                                       err_msg=key, **TOL)


@pytest.mark.parametrize("seed", [0, 11])
def test_sample_actions_matches_jax(pair, seed):
    jmodel, jbase, jtasks, model, base, tasks, example, instruction = pair
    images = example["observation"]["image_primary"]
    key = jax.random.PRNGKey(seed)
    ref, _ = jmodel.sample_actions(
        images, instruction, jtasks,
        example["observation"]["timestep_pad_mask"], jbase, rng=key)
    got = model.sample_actions(
        images, instruction, tasks, None, base,
        rng=Draws(replay=sampler_draws(key, (1, 1, HORIZON * DIM))))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    with pytest.raises(ValueError, match="rng"):
        model.sample_actions(images, instruction, tasks, None, base)


def test_fused_wrapper_ticks_match_jax(pair):
    """Five fused InferenceWrapper ticks (ensembling on), the port's each
    given the draws of the JAX wrapper's key for that tick."""
    jmodel, _, _, model, _, _, example, instruction = pair
    kwargs = dict(policy_setup="libero", pred_action_horizon=HORIZON,
                  image_size=224, action_ensemble=True, fused_serving=True,
                  init_rng=3)
    jwrapper = JaxWrapper(model=jmodel, **kwargs)
    wrapper = InferenceWrapper(model, **kwargs)
    assert jwrapper.fused_serving and wrapper.fused_serving
    for w in (jwrapper, wrapper):
        w.reset("pick up the cube", instruction, example["initial_state"])
    frames = np.random.default_rng(1).integers(
        0, 256, (TICKS, 224, 224, 3), dtype=np.uint8)
    for frame in frames:
        _, key = jax.random.split(jwrapper.rng)  # the key of this tick
        raw_j, act_j, _, _, _ = jwrapper.step(frame)
        raw, act, _, _, _ = wrapper.step(frame, rng=Draws(
            replay=sampler_draws(key, (1, 1, HORIZON * DIM))))
        np.testing.assert_allclose(raw, np.asarray(raw_j), **TOL)
        np.testing.assert_allclose(act, np.asarray(act_j), **TOL)


def test_init_rng_seeds_the_wrapper(pair):
    """Two wrappers with one init_rng serve the same actions; another
    init_rng other actions."""
    _, _, _, model, _, _, example, instruction = pair
    frames = np.random.default_rng(2).integers(
        0, 256, (3, 224, 224, 3), dtype=np.uint8)

    def serve(init_rng, fused):
        wrapper = InferenceWrapper(model, policy_setup="libero",
                                   pred_action_horizon=HORIZON,
                                   image_size=224, init_rng=init_rng,
                                   fused_serving=fused)
        wrapper.reset("pick up the cube", instruction,
                      example["initial_state"])
        return np.stack([wrapper.step(f)[0] for f in frames])

    for fused in (False, True):
        np.testing.assert_array_equal(serve(4, fused), serve(4, fused))
        assert not np.array_equal(serve(4, fused), serve(9, fused))


def test_checkpoint_round_trip_serves_the_same_actions(pair, tmp_path):
    _, _, _, model, base, tasks, example, instruction = pair
    model.save_pretrained(3, str(tmp_path))
    loaded = HyperVLA.load_pretrained(str(tmp_path), device="cpu")
    for name, value in model.params.items():
        assert torch.equal(loaded.params[name], value), name
    images = example["observation"]["image_primary"]
    draws = sampler_draws(jax.random.PRNGKey(6), (1, 1, HORIZON * DIM))
    again, _ = loaded.create_tasks(instruction_dict=instruction,
                                   initial_state=example["initial_state"])
    torch.testing.assert_close(
        loaded.sample_actions(images, instruction, tasks, None, again,
                              rng=Draws(replay=draws)),
        model.sample_actions(images, instruction, tasks, None, base,
                             rng=Draws(replay=copy.deepcopy(draws))),
        rtol=0, atol=0)


def test_k_tick_and_multitask_steps_hand_each_tick_its_rng(pair):
    """The K-tick step hands its one rng to every tick (the JAX scan's one
    key), the multi-task step each task its own (the JAX vmap's rngs[N]):
    both equal the per-tick step given the same draws."""
    from hypervla_tpu_torch.ops import serving

    _, _, _, model, base, _, _, _ = pair
    params = serving.prepare_serving_params(model, base)
    shape = (1, 1, HORIZON * DIM)
    draws = [sampler_draws(jax.random.PRNGKey(k), shape) for k in (1, 2)]
    frames = np.random.default_rng(3).integers(0, 256, (2, 224, 224, 3),
                                               dtype=np.uint8)
    kw = dict(crop=False, ensemble=True)
    tick, init_history = serving.make_serving_step(model, STATS, **kw)
    scan, _ = serving.make_scan_serving_step(model, STATS, 2, **kw)
    history, want = init_history(), []
    for t, frame in enumerate(frames):
        action, history = tick(params, frame, history, t,
                               rng=Draws(replay=draws[0]))
        want.append(action)
    got, _ = scan(params, frames, init_history(), 0,
                  rng=Draws(replay=draws[0]))
    torch.testing.assert_close(got, torch.stack(want), rtol=0, atol=0)
    multi, _, stack = serving.make_multitask_serving_step(model, STATS, **kw)
    histories = torch.stack([init_history(), init_history()])
    got, _ = multi(stack([params, params]), frames, histories,
                   np.zeros(2, int),
                   rngs=[Draws(replay=d) for d in draws])
    for i, frame in enumerate(frames):
        action, _ = tick(params, frame, init_history(), 0,
                         rng=Draws(replay=draws[i]))
        torch.testing.assert_close(got[i], action, rtol=0, atol=0)
    assert not torch.equal(got[0], got[1])
