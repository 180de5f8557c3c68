"""The port's fp32 DINOv2 (hypervla_tpu_torch/models/encoders/dinov2.py)
against the JAX package's DINOv2Model on the same params, on the CPU:
embeddings, the fp32 layer loop and the final LayerNorm at `dinov2-test`
size, and the bicubic position interpolation from the 518-px grid of
dinov2-base to 224 px."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervla_tpu.models.encoders import dinov2 as jd
from hypervla_tpu_torch import configs
from hypervla_tpu_torch.models.encoders import dinov2 as td
from hypervla_tpu_torch.utils.convert import from_jax_params
from test_torch_harness import torch_threads  # noqa: F401

TOL = 1e-5


@pytest.fixture(scope="module")
def tiny():
    cfg = jd.dinov2_config("dinov2-test")
    rng = np.random.default_rng(0)
    pixels = rng.standard_normal((1, 224, 224, 3)).astype(np.float32)
    model = jd.DINOv2Model(config=cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(pixels))["params"]
    # non-trivial norms, layer scales and biases
    params = jax.tree_util.tree_map(
        lambda v: v + 0.1 * jnp.asarray(
            rng.standard_normal(v.shape), v.dtype) if v.ndim == 1 else v,
        params,
    )
    return cfg, params, pixels


def test_embeddings_match(tiny):
    cfg, params, pixels = tiny
    ref = jd._Embeddings(cfg).apply({"params": params["embeddings"]},
                                    jnp.asarray(pixels))
    got = td.embeddings(configs.dinov2_config("dinov2-test"),
                        from_jax_params(params), torch.tensor(pixels),
                        torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)


def test_fp32_forward_matches(tiny):
    cfg, params, pixels = tiny
    ref = jd.DINOv2Model(config=cfg).apply(
        {"params": params}, jnp.asarray(pixels)).last_hidden_state
    got = td.dinov2_forward(configs.dinov2_config("dinov2-test"),
                            from_jax_params(params), torch.tensor(pixels))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)


def test_position_interpolation_518_to_224():
    """dinov2-base trains at 518 px (37x37 grid); serving runs at 224 px
    (16x16): bicubic scale_and_translate with the +0.1 extent."""
    rng = np.random.default_rng(1)
    dim = 32
    pos = rng.standard_normal((1, 37 * 37 + 1, dim)).astype(np.float32)
    hidden = jnp.zeros((1, 16 * 16 + 1, dim))
    ref = jd._interpolate_pos_encoding(jd.dinov2_config("dinov2-base"),
                                       hidden, 224, 224, jnp.asarray(pos))
    got = td.interpolate_pos_encoding(configs.dinov2_config("dinov2-base"),
                                      torch.tensor(pos), 224, 224)
    assert got.shape == (1, 257, dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)


def test_param_specs_match_jax_init(tiny):
    """The port's DINOv2 param plan names and shapes every leaf of the
    JAX module's init."""
    _, params, _ = tiny
    specs = td.dinov2_specs(configs.dinov2_config("dinov2-test"), "enc")
    ref = {f"enc/{k}": tuple(v.shape)
           for k, v in from_jax_params(params).items()}
    assert {k: tuple(s) for k, (s, _) in specs.items()} == ref
