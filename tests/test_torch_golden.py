"""The port reproduces the stored `dinov2_shared` reference golden
(tests/goldens/reference_parity/dinov2_shared/, the flagship topology at
tiny size): the reference hypernet params go through the JAX package's
converter and the port's weight bridge, and the port must reproduce the
generated base-net weights and the sampled action to 1e-5, the checks of
tests/test_reference_parity.py."""
import os

import numpy as np
import pytest

from hypervla_tpu.utils.convert import convert_reference_params
from hypervla_tpu_torch.configs import tiny_test_config
from hypervla_tpu_torch.models.hypervla import HyperVLA
from hypervla_tpu_torch.utils.convert import flatten_tree, from_jax_params

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "reference_parity", "dinov2_shared")


def _load(name):
    import flax.serialization

    with open(os.path.join(GOLDEN, name), "rb") as f:
        return convert_reference_params(
            flax.serialization.msgpack_restore(f.read()))


@pytest.fixture(scope="module")
def golden():
    io = dict(np.load(os.path.join(GOLDEN, "io.npz")))
    batch = {
        "task": {"language_instruction": {
            "token_embedding": io["token_embedding"]}},
        "initial_state": {"patch_embeddings": io["initial_patch_embeddings"]},
    }
    model = HyperVLA.from_config(tiny_test_config(), batch, device="cpu")
    ref_params = from_jax_params(_load("hypernet_params.msgpack"))
    assert set(ref_params) == set(model.params)
    for name, value in ref_params.items():
        assert value.shape == model.params[name].shape, name
    model.params = ref_params
    instruction = {"language_instruction": {
        "token_embedding": io["token_embedding"],
        "attention_mask": io["attention_mask"],
    }}
    base_params, _ = model.create_tasks(
        instruction, {"patch_embeddings": io["initial_patch_embeddings"]})
    return model, io, base_params


def test_generated_weights_match_golden(golden):
    _, _, base_params = golden
    ref = flatten_tree(_load("generated_base_params.msgpack"))
    assert set(ref) == set(base_params)
    for name, value in ref.items():
        np.testing.assert_allclose(base_params[name].numpy(), value,
                                   atol=1e-5, err_msg=name)


def test_action_matches_golden(golden):
    model, io, base_params = golden
    action = model.sample_actions(io["image"], base_params)
    np.testing.assert_allclose(action.numpy(), io["action"], atol=1e-5)
