"""The trunk's named remat policies "dots" and "dots_no_batch" against the
JAX reference with the same policy (jax.checkpoint_policies.
checkpoint_dots, checkpoint_dots_with_no_batch_dims) on the tiny DINOv2
twin with the trunk fine-tuned, to 1e-5 (tests/test_torch_remat.py)."""
import jax
import numpy as np
import pytest

from hypervla_tpu_torch.models.draws import Draws
from test_torch_harness import torch_threads  # noqa: F401
from test_torch_jax_draws import (
    assert_grads_close,
    build_pair,
    dropout_keys,
    jax_reference,
    port_step_grads,
    with_config,
)
from test_torch_remat import BATCH, _fine_tune, _setting


@pytest.fixture(scope="module")
def pair():
    return build_pair(_fine_tune, batch_size=BATCH)


@pytest.mark.parametrize("name", ["dots", "dots_no_batch"])
def test_remat_policy_matches_jax(pair, name):
    jmodel, jconfig, model, config, jbatch, batch = with_config(
        pair, _setting(name))
    ref = jax_reference(jmodel, jconfig, jbatch,
                        dropout_keys(jax.random.PRNGKey(0), BATCH))
    info, grads = port_step_grads(model, config, batch,
                                  Draws(replay=ref["sites"]))
    np.testing.assert_allclose(info["training_loss"], ref["loss"], rtol=1e-5)
    assert_grads_close(grads, ref["grads"])
