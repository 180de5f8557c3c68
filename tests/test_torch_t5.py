"""The port's frozen T5 encoder (hypervla_tpu_torch/models/encoders/t5.py)
against the JAX package's T5EncoderModel on the same params and a padded
mask, fp32 on the CPU, and the port's param plan against the JAX init."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervla_tpu.models.encoders import t5 as jt5
from hypervla_tpu_torch.models.encoders import t5 as tt5
from hypervla_tpu_torch.utils.convert import from_jax_params

SMALL = dict(vocab_size=97, d_model=64, d_kv=16, d_ff=128, num_layers=2,
             num_heads=4)


@pytest.fixture(scope="module")
def small():
    cfg = jt5.T5Config(**SMALL)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, SMALL["vocab_size"], (3, 11)).astype(np.int32)
    mask = np.ones((3, 11), np.int32)
    mask[1, 7:] = 0
    mask[2, 3:] = 0
    model = jt5.T5EncoderModel(config=cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"]
    # non-trivial RMS-norm weights
    params = jax.tree_util.tree_map(
        lambda v: v + 0.1 * jnp.asarray(rng.standard_normal(v.shape),
                                        v.dtype) if v.ndim == 1 else v,
        params)
    return model, params, ids, mask


@pytest.mark.parametrize("with_mask", [True, False])
def test_t5_encoder_matches_jax(small, with_mask):
    model, params, ids, mask = small
    jmask = jnp.asarray(mask) if with_mask else None
    ref = model.apply({"params": params}, jnp.asarray(ids), jmask)
    got = tt5.t5_encode(tt5.T5Config(**SMALL), from_jax_params(params),
                        torch.tensor(ids),
                        torch.tensor(mask) if with_mask else None)
    assert got.dtype == torch.float32 and got.shape == (3, 11, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_relative_position_buckets_match_jax():
    rel = np.arange(-200, 200)[None, :] - np.arange(40)[:, None]
    np.testing.assert_array_equal(tt5.relative_position_bucket(rel),
                                  jt5._relative_position_bucket(rel))


def test_t5_specs_match_jax_init(small):
    _, params, _, _ = small
    specs = tt5.t5_specs(tt5.T5Config(**SMALL))
    ref = {k: tuple(v.shape) for k, v in from_jax_params(params).items()}
    assert {k: tuple(s) for k, (s, _) in specs.items()} == ref
