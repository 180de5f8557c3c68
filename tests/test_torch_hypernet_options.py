"""The hypernetwork's options (hypervla_tpu/models/hypernetwork.py,
weight_plan.py, hypervla.py:204-233) against the JAX package on the tiny
DINOv2 twin on the CPU, the port loaded with the JAX package's initial
params (output-head kernels perturbed): the generated params, the loss and
every gradient of one step to 1e-5 (tests/test_torch_jax_draws.py::
jax_reference), and the plan's output heads (names, init strategy and
variance) against the JAX plan's:

  * output_head_bias=False, the context encoder's add_position_embedding
    and share_TF_output_head, together ("block" generation);
  * init_strategy VARIANCE_INIT: tests/test_torch_hypernet_init.py;
  * "full" generation without output-head biases:
    tests/test_torch_full_generation.py.
"""
import re

import jax
import numpy as np
import pytest
import torch

from hypervla_tpu.models.weight_plan import flatten_info_dict
from hypervla_tpu_torch.train.train_step import to_tensors
from hypervla_tpu_torch.utils.convert import drop_unread_params
from test_torch_harness import torch_threads  # noqa: F401
from test_torch_jax_draws import (
    assert_grads_close,
    build_pair,
    dropout_keys,
    jax_reference,
    port_step_grads,
)

BATCH = 2


def check_pair(pair):
    """The plan's heads against the JAX metadata, then one step."""
    jmodel, jconfig, model, config, jbatch, batch = pair
    info = flatten_info_dict(jmodel.base_net_metadata["output_head_info"])
    plan = model.plan
    assert set(plan.output_head_info) == set(info)
    for head, want in info.items():
        got = plan.output_head_info[head]
        for key in ("output_dim", "generation_flag", "init_strategy"):
            assert got[key] == want[key], (head, key)
        np.testing.assert_allclose(got["init_variance"],
                                   want["init_variance"], rtol=1e-7)
    ref = jax_reference(jmodel, jconfig, jbatch,
                        dropout_keys(jax.random.PRNGKey(0), BATCH))
    info_t, grads = port_step_grads(model, config, batch, None)
    np.testing.assert_allclose(info_t["training_loss"], ref["loss"],
                               rtol=1e-5)
    # the output-head biases the JAX bias-init protocol writes and no
    # module reads (utils/convert.py::drop_unread_params) take no gradient
    kept = drop_unread_params(ref["grads"], config)
    for name in set(ref["grads"]) - set(kept):
        assert not np.asarray(ref["grads"][name]).any(), name
    assert_grads_close(grads, kept)
    b = to_tensors(batch, "cpu")
    with torch.no_grad():
        ctx = model.hypernet.task_context(
            model.params, b["task"], b["task"]["language_instruction"][
                "token_embedding"], b["initial_state"]["patch_embeddings"])
        generated = model.hypernet.generate(model.params, ctx)
    assert set(ref["generated"]) == {n for n in plan.names
                                     if plan.generation_flag[n]}
    for name, value in ref["generated"].items():
        np.testing.assert_allclose(generated[name].numpy(), value,
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    return model


def _options(config):
    hk = config["hypernet_kwargs"]
    hk.update(output_head_bias=False, share_TF_output_head=True,
              share_layer_index=False)
    hk["context_encoder_kwargs"]["add_position_embedding"] = True


@pytest.fixture(scope="module")
def pair():
    return build_pair(_options, batch_size=BATCH)


def test_bias_free_shared_tf_heads_with_positions_match_jax(pair):
    model = check_pair(pair)
    params = model.params
    assert not any(k.startswith("output_head_") and k.endswith("/bias")
                   for k in params)
    assert "context_encoder/posembed_input/pos_embedding" in params
    heads = [k for k in params if "Transformer_0_encoderblock" in k]
    assert heads and not any(re.search(r"encoderblock_\d", k)
                             for k in heads)
