"""The conv + MLP policy (hypervla_tpu_torch/models/base_cnn.py::CNN)
against the JAX package's CNN.apply on the same params and frames, and
model_type "cnn" refused with a TypeError in both packages: the JAX
BaseNetwork calls its encoder with the instruction embeddings, train and
image_embeddings, which CNN.__call__ does not take, so the JAX model fails
at init, and the port's BaseNetwork raises the same type at build."""
import jax
import numpy as np
import pytest
import torch

from hypervla_tpu.configs import tiny_test_config as jax_tiny_config
from hypervla_tpu.flagship import make_flagship_batch as jax_batch
from hypervla_tpu.models.base_cnn import CNN as JaxCNN
from hypervla_tpu.models.hypervla import HyperVLA as JaxHyperVLA
from hypervla_tpu_torch.configs import pretrain_config, tiny_test_config
from hypervla_tpu_torch.flagship import make_flagship_batch
from hypervla_tpu_torch.models.base_cnn import CNN
from hypervla_tpu_torch.models.hypervla import HyperVLA
from hypervla_tpu_torch.utils.convert import from_jax_params
from test_torch_harness import torch_threads  # noqa: F401

#: the JAX default config's cnn_kwargs (hypervla_tpu/configs/defaults.py)
DEFAULT = pretrain_config()["base_net_kwargs"]["cnn_kwargs"]
CASES = {
    "default": (DEFAULT, 64),
    "two stages": (dict(features=(32, 64), kernel_sizes=(3, 5),
                        strides=(2, 1), padding=(1, 2),
                        mlp_hidden_sizes=(16,), output_dim=7), 32),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cnn_matches_jax(case):
    kwargs, size = CASES[case]
    jcnn, cnn = JaxCNN(**kwargs), CNN(**kwargs)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (3, size, size, 3), dtype=np.uint8)
    variables = jcnn.init(jax.random.PRNGKey(0), images)
    params = jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + 0.05 * rng.standard_normal(v.shape)
                   ).astype(np.float32), variables["params"])
    ref = jcnn.apply({"params": params}, images)
    ported = from_jax_params(params)
    specs = cnn.specs((size, size))
    assert {k: tuple(v.shape) for k, v in ported.items()} == {
        k: tuple(s) for k, (s, _) in specs.items()}
    got = cnn(ported, torch.tensor(images))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_port_cnn_init_builds_from_its_specs():
    from hypervla_tpu_torch.models import layers

    cnn = CNN(**DEFAULT)
    params = layers.init_params(cnn.specs((64, 64)), seed=0)
    out = cnn(params, torch.zeros((2, 64, 64, 3), dtype=torch.uint8))
    assert out.shape == (2, 4) and torch.isfinite(out).all()


@pytest.mark.parametrize("head", ["diffusion", "mix"])
def test_model_type_cnn_raises_type_error_in_both_packages(head):
    jconfig = jax_tiny_config("SmallStem", action_head_type=head)
    jconfig["base_net_kwargs"]["model_type"] = "cnn"
    with pytest.raises(TypeError, match="train"):
        JaxHyperVLA.from_config(
            jconfig, jax_batch(instr_len=8, action_horizon=2, image_size=64,
                               initial_patch_dim=32),
            jax.random.PRNGKey(0))
    config = tiny_test_config("SmallStem", action_head_type=head)
    config["base_net_kwargs"]["model_type"] = "cnn"
    with pytest.raises(TypeError, match="CNN.__call__"):
        HyperVLA.from_config(config, make_flagship_batch(
            instr_len=8, action_horizon=2, image_size=64,
            initial_patch_dim=32), device="cpu")
