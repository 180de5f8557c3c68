"""The port reproduces the five stored reference goldens
(tests/goldens/reference_parity/<case>/, written by the reference HyperVLA,
scripts/gen_reference_goldens.py): the reference hypernet params go
through the JAX package's converter and the port's weight bridge, and the
port must reproduce the generated base-net weights and the sampled action
to 1e-5, the checks of tests/test_reference_parity.py, with its per-case
configs:

  * base, perturbed, continuous_head: the JAX tiny config's generated
    SmallStem policy over 64-px frames, block generation (perturbed: random
    fan-out kernels, so the generation depends on the context), the mix
    head or the continuous head;
  * initial_image: the same conditioned on the initial image's patch
    embeddings, with scaled context embeddings;
  * dinov2_shared: the flagship topology at tiny size, the shared DINOv2
    trunk.
"""
import os

import numpy as np
import pytest

from hypervla_tpu.utils.convert import convert_reference_params
from hypervla_tpu_torch.configs import tiny_test_config
from hypervla_tpu_torch.models.hypervla import HyperVLA
from hypervla_tpu_torch.utils.convert import flatten_tree, from_jax_params
from test_torch_harness import torch_threads  # noqa: F401

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens",
                       "reference_parity")
#: tests/test_reference_parity.py's CASE_CONFIG, as the port's config
CASE_CONFIG = {
    "base": dict(encoder_type="SmallStem"),
    "perturbed": dict(encoder_type="SmallStem"),
    "initial_image": dict(
        encoder_type="SmallStem",
        hypernet_kwargs=dict(use_initial_image=True,
                             scale_context_embedding=True)),
    "dinov2_shared": dict(encoder_type="DINOv2"),
    "continuous_head": dict(encoder_type="SmallStem",
                            action_head_type="continuous"),
}
CASES = sorted(CASE_CONFIG)


def _load(case, name):
    import flax.serialization

    with open(os.path.join(GOLDENS, case, name), "rb") as f:
        return convert_reference_params(
            flax.serialization.msgpack_restore(f.read()))


@pytest.fixture(scope="module", params=CASES)
def golden(request):
    case = request.param
    io = dict(np.load(os.path.join(GOLDENS, case, "io.npz")))
    batch = {
        "observation": {"image_primary": io["image"]},
        "task": {"language_instruction": {
            "token_embedding": io["token_embedding"]}},
    }
    initial_state = None
    if "initial_patch_embeddings" in io:
        initial_state = {"patch_embeddings": io["initial_patch_embeddings"]}
        batch["initial_state"] = initial_state
    model = HyperVLA.from_config(tiny_test_config(**CASE_CONFIG[case]), batch,
                                 device="cpu")
    ref_params = from_jax_params(_load(case, "hypernet_params.msgpack"))
    assert set(ref_params) == set(model.params)
    for name, value in ref_params.items():
        assert value.shape == model.params[name].shape, name
    model.params = ref_params
    instruction = {"language_instruction": {
        "token_embedding": io["token_embedding"],
        "attention_mask": io["attention_mask"],
    }}
    base_params, tasks = model.create_tasks(
        instruction_dict=instruction, initial_state=initial_state)
    return case, model, io, base_params, tasks


def test_generated_weights_match_golden(golden):
    case, _, _, base_params, _ = golden
    ref = flatten_tree(_load(case, "generated_base_params.msgpack"))
    assert set(ref) == set(base_params)
    for name, value in ref.items():
        np.testing.assert_allclose(base_params[name].numpy(), value,
                                   atol=1e-5, err_msg=f"{case}: {name}")


def test_action_matches_golden(golden):
    case, model, io, base_params, tasks = golden
    action = model.sample_actions(io["image"], tasks, tasks, None,
                                  base_params)
    np.testing.assert_allclose(action.numpy(), io["action"], atol=1e-5,
                               err_msg=case)
