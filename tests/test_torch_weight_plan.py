"""The port's weight plan (hypervla_tpu_torch/models/weight_plan.py),
derived from the config, against the JAX package's base_net_metadata,
derived from a flax init: block names in order, shapes, generation flags,
context-token indices, layer_token_mask, output-head info and the
delta-decay name table (flat names, pretrained block path), exactly."""
import jax
import numpy as np
import pytest
import torch

from helpers import make_example_batch
from hypervla_tpu.configs import tiny_test_config as jax_tiny_config
from hypervla_tpu.models.hypervla import HyperVLA as JaxHyperVLA
from hypervla_tpu_torch.configs import tiny_test_config
from hypervla_tpu_torch.models.weight_plan import init_base_net
from test_torch_harness import torch_threads  # noqa: F401


def _leaves(tree):
    return [("/".join(k.key for k in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _leaves_of(table, prefix=""):
    """A nested dict's leaves as ("a/b", leaf)."""
    for key, value in table.items():
        if isinstance(value, dict):
            yield from _leaves_of(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", value


@pytest.mark.parametrize("hk", [
    dict(share_layer_index=True),
    # one context token per module group: exercises the token indices
    dict(share_layer_index=False),
    dict(share_layer_index=False, shared_modules=("image_encoder",
                                                  "encoder_norm")),
])
def test_plan_matches_jax(hk):
    batch = make_example_batch(image_size=224, initial_image=True,
                               initial_patch_dim=32)
    jmodel = JaxHyperVLA.from_config(
        jax_tiny_config(encoder_type="DINOv2", hypernet_kwargs=dict(hk)),
        batch, jax.random.PRNGKey(0))
    md = jmodel.base_net_metadata
    _, init, plan = init_base_net(tiny_test_config(hypernet_kwargs=dict(hk)),
                                  torch.Generator().manual_seed(0))

    shapes = _leaves(md["param_shape"])
    assert [n for n, _ in shapes] == plan.names
    assert {n: tuple(s) for n, s in shapes} == plan.param_shape
    assert dict(_leaves(md["generation_flag"])) == plan.generation_flag
    assert dict(_leaves(md["token_index_dict"])) == plan.token_index
    assert tuple(md["layer_token_mask"]) == plan.layer_token_mask
    assert md["block_num"] == plan.block_num
    assert md["total_param_num"] == plan.total_param_num
    assert md["output_head_info"] == plan.output_head_info
    # delta-decay's name table and where the pretrained trunk sits
    assert dict(_leaves(md["flat_name"])) == dict(
        _leaves_of(plan.flat_name_table()))
    assert md["pretrained_block_path"] == plan.pretrained_block_path
    assert {n: tuple(v.shape) for n, v in init.items()} == plan.param_shape
    assert all(np.isfinite(v.numpy()).all() for v in init.values())
