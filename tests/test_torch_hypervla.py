"""The port's HyperVLA facade (hypervla_tpu_torch/models/hypervla.py): the
bias-init protocol and the hypernetwork forward against the JAX package's
on the same params."""
import jax
import numpy as np
import pytest
import torch

from helpers import make_example_batch
from hypervla_tpu.configs import tiny_test_config as jax_tiny_config
from hypervla_tpu.models.hypervla import HyperVLA as JaxHyperVLA
from hypervla_tpu_torch.configs import tiny_test_config
from hypervla_tpu_torch.flagship import make_flagship_batch
from hypervla_tpu_torch.models.hypervla import HyperVLA
from hypervla_tpu_torch.models.weight_plan import init_base_net
from hypervla_tpu_torch.utils.convert import from_jax_params


def _instruction(batch):
    return {"language_instruction": batch["task"]["language_instruction"]}


@pytest.mark.parametrize("seed", [0, 3])
def test_bias_init_protocol_emits_fresh_base_init(seed):
    """Zero fan-out kernels: any task generates exactly the fresh base-net
    init that from_config drew (hypervla_tpu/models/hypervla.py:160-262)."""
    config = tiny_test_config()
    batch = make_flagship_batch(instr_len=8, initial_patch_dim=32, seed=seed)
    model = HyperVLA.from_config(config, batch, seed=seed)
    _, fresh, _ = init_base_net(config, torch.Generator().manual_seed(seed))
    base_params, _ = model.create_tasks(_instruction(batch),
                                        batch["initial_state"])
    assert set(base_params) == set(fresh)
    for name, value in fresh.items():
        assert torch.equal(base_params[name], value), name


@pytest.mark.parametrize("hk", [
    dict(),
    dict(share_layer_index=False, task_attend_to_layer=True,
         use_all_image_tokens=True, attend_to_padding=True),
])
def test_hypernet_forward_matches_jax(hk):
    """Perturbed fan-out kernels make the generated weights depend on the
    context: the context encoder, its mask and the packed fan-out must
    match the JAX package's on the same params, padded instruction tokens
    included."""
    batch = make_example_batch(image_size=224, initial_image=True,
                               initial_patch_dim=32, seed=4)
    batch["task"]["language_instruction"]["attention_mask"][:, 5:] = 0
    jmodel = JaxHyperVLA.from_config(
        jax_tiny_config(encoder_type="DINOv2", hypernet_kwargs=dict(hk)),
        batch, jax.random.PRNGKey(1))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(np.asarray, jmodel.params)
    for name, head in params.items():
        if name.startswith("output_head_"):
            head["kernel"] = head["kernel"] + 0.02 * rng.standard_normal(
                head["kernel"].shape).astype(np.float32)
    jmodel = jmodel.replace(params=params)
    example = jax.tree_util.tree_map(lambda x: np.asarray(x)[:1], batch)
    ref, _, _ = jmodel.create_tasks(
        instruction_dict=_instruction(example),
        initial_state=example["initial_state"])

    model = HyperVLA.from_config(tiny_test_config(hypernet_kwargs=dict(hk)),
                                 example)
    model.params = from_jax_params(params)
    got, _ = model.create_tasks(_instruction(example),
                                example["initial_state"])
    ref = dict(("/".join(k.key for k in path), v) for path, v in
               jax.tree_util.tree_flatten_with_path(ref)[0])
    assert set(ref) == set(got)
    for name, value in ref.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(value),
                                   atol=1e-5, err_msg=name)
