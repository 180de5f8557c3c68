"""Goal images (hypernet_kwargs include_goal_image;
hypervla_tpu/models/hypernetwork.py:204-216, 249-253) against the JAX
package on the tiny DINOv2 twin on the CPU: the task's image_primary
through a SmallStem16 whose GroupNorms have no scale or bias, projected to
the context width with its own position table, attended where the task's
pad mask holds (one sample's goal padded out here). One step from the
JAX package's initial params as tests/test_torch_hypernet_options.py::
check_pair holds it (generated params, loss, every gradient to 1e-5),
create_tasks against the JAX model's (the goal zeros, padded out, in
both), and the goal stem alone against the JAX SmallStem16."""
import flax
import jax
import numpy as np
import pytest

from hypervla_tpu_torch.utils.convert import flatten_tree

from test_torch_harness import torch_threads  # noqa: F401
from test_torch_hypernet_options import BATCH, check_pair
from test_torch_jax_draws import build_pair

GOAL = 64


def _goal(config):
    config["hypernet_kwargs"]["include_goal_image"] = True


def _goal_batch(batch):
    rng = np.random.default_rng(4)
    batch["task"]["image_primary"] = rng.integers(
        0, 256, (BATCH, GOAL, GOAL, 3), dtype=np.uint8)
    batch["task"]["pad_mask_dict"]["image_primary"] = np.array(
        [True] * (BATCH - 1) + [False])


@pytest.fixture(scope="module")
def pair():
    return build_pair(_goal, batch_size=BATCH, batch_change=_goal_batch)


def test_goal_image_step_matches_jax(pair):
    model = check_pair(pair)
    params = model.params
    assert "SmallStem16_0/StdConv_3/kernel" in params
    assert not any(k.startswith("SmallStem16_0/GroupNorm") for k in params)
    assert params["goal_image_pos_embedding"].shape == (1, 16, 16)


def test_create_tasks_with_a_goal_matches_jax(pair):
    """One task's generated params at serving time against the JAX
    model's create_tasks, which fills the goal frame with zeros, padded
    out."""
    jmodel, _, model, _, jbatch, _ = pair
    example = jax.tree_util.tree_map(lambda x: np.asarray(x)[:1], jbatch)
    instruction = {"language_instruction":
                   example["task"]["language_instruction"]}
    ref, _, _ = jmodel.create_tasks(instruction_dict=instruction,
                                    initial_state=example["initial_state"])
    base, tasks = model.create_tasks(
        instruction_dict=instruction, initial_state=example["initial_state"])
    assert tasks["image_primary"].shape == (1, GOAL, GOAL, 3)
    assert not tasks["pad_mask_dict"]["image_primary"].any()
    flags = model.plan.generation_flag
    for name, value in flatten_tree(
            jax.device_get(flax.core.unfreeze(ref))).items():
        if flags[name]:
            np.testing.assert_allclose(base[name].numpy(), np.asarray(value),
                                       rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("size", [64, 96])
def test_goal_stem_matches_jax_smallstem16(size):
    """The goal-image stem alone: the port's SmallStem with the JAX
    SmallStem16's fields (patch 16, learnable_norm=False) against it on
    the JAX init, perturbed, to 1e-5."""
    from hypervla_tpu.models.vit_encoders import SmallStem16
    from hypervla_tpu_torch.models.hypernetwork import GOAL_STEM
    from hypervla_tpu_torch.utils.convert import from_jax_params

    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (2, size, size, 3), dtype=np.uint8)
    stem = SmallStem16(learnable_norm=False)
    variables = stem.init(jax.random.PRNGKey(0), images)
    variables = jax.tree_util.tree_map(
        lambda v: (v + rng.standard_normal(v.shape) * 0.05).astype(
            np.float32), variables)
    ref = np.asarray(stem.apply(variables, images))
    params = {f"s/{k}": v for k, v in from_jax_params(
        jax.tree_util.tree_map(np.asarray, variables["params"])).items()}
    assert set(params) == set(GOAL_STEM.specs("s"))
    import torch

    got = GOAL_STEM(params, "s", torch.as_tensor(images))
    assert GOAL_STEM.num_tokens(size, size) == got.shape[1]
    np.testing.assert_allclose(got.numpy(), ref.reshape(2, -1, 512),
                               rtol=1e-5, atol=1e-5)
