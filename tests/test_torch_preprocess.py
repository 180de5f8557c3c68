"""The port's frame preprocessing (hypervla_tpu_torch/ops/preprocess.py)
against the JAX package's on the same frames, on the CPU: lanczos3 resize
with antialiasing, the sqrt(0.9) centre crop and the padded resize. The
first two output uint8: the two may round a value that sits at .5
differently, so the bound is at most one level on at most 0.1% of the
pixels."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervla_tpu.eval.inference import (
    _crop_and_resize_bilinear,
    _resize_with_pad,
)
from hypervla_tpu.ops.preprocess import resize_image
from hypervla_tpu_torch.ops import preprocess
from test_torch_harness import torch_threads  # noqa: F401


def _assert_close_u8(got, ref):
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert got.shape == ref.shape
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() <= 1e-3, (diff > 0).mean()


@pytest.mark.parametrize("shape", [(256, 320, 3), (480, 640, 3),
                                   (256, 256, 3), (224, 224, 3)])
def test_lanczos3_resize_matches(shape):
    frame = np.random.default_rng(sum(shape)).integers(
        0, 256, shape, dtype=np.uint8)
    ref = np.asarray(resize_image(jnp.asarray(frame), (224, 224)))
    got = preprocess.resize_image(torch.from_numpy(frame), (224, 224))
    assert got.dtype == torch.uint8
    _assert_close_u8(got.numpy(), ref)


def test_center_crop_matches():
    frame = np.random.default_rng(7).integers(0, 256, (224, 224, 3),
                                              dtype=np.uint8)
    scale = float(np.sqrt(0.9))
    offset = (1 - scale) / 2
    ref = _crop_and_resize_bilinear(
        jnp.asarray(frame, jnp.float32),
        (offset, offset, offset + scale, offset + scale), (224, 224))
    ref = np.asarray(jnp.clip(jnp.round(ref), 0, 255).astype(jnp.uint8))
    got = preprocess.center_crop(torch.from_numpy(frame), (224, 224))
    _assert_close_u8(got.numpy(), ref)


@pytest.mark.parametrize("shape", [(200, 300, 3), (480, 640, 3),
                                   (256, 320, 3), (120, 90, 3)])
def test_resize_with_pad_matches(shape):
    """The host path's padded resize to 256x320 (bilinear, antialiased,
    zero-padded around the centre; fp32, not rounded), from a downsample,
    an identity and an upsample. Both packages place each sample in fp32,
    where XLA may fuse the position's arithmetic: one ulp of a position up
    to 320 moves a bilinear weight by 320 * 2^-23, a pixel by 255 times
    that."""
    frame = np.random.default_rng(sum(shape)).integers(
        0, 256, shape, dtype=np.uint8)
    ref = np.asarray(_resize_with_pad(jnp.asarray(frame), 256, 320))
    got = preprocess.resize_with_pad(torch.from_numpy(frame), 256, 320)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=255 * 320 * 2.0 ** -23)
