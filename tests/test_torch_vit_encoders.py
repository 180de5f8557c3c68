"""The port's patch encoders (hypervla_tpu_torch/models/vit_encoders.py and
the convolution and GroupNorm of models/layers.py) against the JAX
package's (hypervla_tpu/models/vit_encoders.py) on the CPU, fp32 to 1e-5,
with the same params through utils/convert.py::from_jax_params and the
same inputs from a numpy seed.

The layout comes first: JAX convolves NHWC activations with HWIO kernels,
the port NCHW activations with the kernel laid out at the conv, and the
tokens leave in NHWC row-major order. Then each module, and the
per-sample convolution of generated kernels (one grouped convolution)
against JAX's vmap over the same kernels.
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from hypervla_tpu.models import vit_encoders as jve
from hypervla_tpu_torch.models import layers
from hypervla_tpu_torch.models import vit_encoders as ve
from hypervla_tpu_torch.utils.convert import from_jax_params
from test_torch_harness import torch_threads  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _params(variables, prefix="m"):
    tree = jax.tree_util.tree_map(np.asarray, variables["params"])
    return {f"{prefix}/{k}": v for k, v in from_jax_params(tree).items()}


def _nchw(x):
    return torch.tensor(np.asarray(x)).permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("stride,padding", [(1, 0), (2, 1), (2, 0)])
def test_one_conv_layout_matches_lax(stride, padding):
    """An HWIO kernel over NHWC activations (lax) against the port's conv
    on NCHW activations: the same numbers at every (h, w, c)."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 7, 3).astype(np.float32)
    kernel = rng.randn(3, 3, 3, 5).astype(np.float32)
    bias = rng.randn(5).astype(np.float32)
    ref = lax.conv_general_dilated(
        x, kernel, (stride, stride), [(padding, padding)] * 2,
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + bias
    got = layers.conv2d(_nchw(x), torch.tensor(kernel), torch.tensor(bias),
                        stride, padding)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), **TOL)


def test_one_patchify_layout_matches_flax():
    """The strided VALID `embedding` conv and the tokens' (h, w) order."""
    rng = np.random.RandomState(1)
    images = rng.randint(0, 256, (2, 32, 48, 3)).astype(np.uint8)
    enc = jve.PatchEncoder(patch_size=16, num_features=8)
    variables = enc.init(jax.random.PRNGKey(0), images)
    ref = np.asarray(enc.apply(variables, images))
    got = ve.PatchEncoder(patch_size=16, num_features=8)(
        _params(variables), "m", torch.tensor(images))
    assert got.shape == (2, 6, 8)
    np.testing.assert_allclose(got.numpy(), ref.reshape(2, -1, 8), **TOL)
    assert ve.PatchEncoder(patch_size=16).num_tokens(32, 48) == 6


@pytest.mark.parametrize("padding,stride", [(1, 2), (0, 1)])
def test_std_conv_matches_flax(padding, stride):
    """StdConv: the kernel re-centred and divided by its population std
    plus eps over (h, w, in) each forward."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    conv = jve.StdConv(features=6, kernel_size=(3, 3), strides=(stride,
                                                                stride),
                       padding=padding)
    variables = conv.init(jax.random.PRNGKey(1), x)
    variables = jax.tree_util.tree_map(
        lambda v: v + rng.randn(*v.shape).astype(np.float32) * 0.1, variables)
    ref = np.asarray(conv.apply(variables, x))
    got = ve.std_conv(_params(variables), "m", _nchw(x), stride, padding)
    np.testing.assert_allclose(_nhwc(got), ref, **TOL)


@pytest.mark.parametrize("channels", [32, 64])
def test_group_norm_matches_flax(channels):
    """flax GroupNorm (32 groups, eps 1e-6, fast variance): one channel a
    group at 32 channels, two at 64."""
    rng = np.random.RandomState(3)
    x = (rng.randn(2, 5, 6, channels) * 3 + 1).astype(np.float32)
    norm = nn.GroupNorm()
    variables = {"params": {
        "scale": rng.randn(channels).astype(np.float32),
        "bias": rng.randn(channels).astype(np.float32)}}
    ref = np.asarray(norm.apply(variables, x))
    p = _params(variables)
    got = layers.group_norm(_nchw(x), p["m/scale"], p["m/bias"])
    np.testing.assert_allclose(_nhwc(got), ref, **TOL)


def test_normalize_images_matches_jax():
    """The stems' normalization: the JAX function's "default"."""
    images = np.random.RandomState(4).randint(0, 256, (2, 4, 4, 6)).astype(
        np.uint8)
    np.testing.assert_allclose(
        ve.normalize_images(torch.tensor(images)).numpy(),
        np.asarray(jve.normalize_images(images, "default")), **TOL)


def _perturbed(variables, seed):
    """Random values in every leaf, so that the GroupNorm's scale and bias
    and the biases are not their init."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda v: (v + rng.randn(*v.shape) * 0.2).astype(np.float32),
        variables)


@pytest.mark.parametrize("kwargs,size", [
    (dict(patch_size=16, features=(32, 32, 32, 32)), 64),
    (dict(patch_size=32, features=(32, 64, 32, 32)), 64),
    (dict(patch_size=16, features=(32, 32, 32)), 48),
])
def test_small_stem_matches_flax(kwargs, size):
    rng = np.random.RandomState(5)
    images = rng.randint(0, 256, (2, size, size, 3)).astype(np.uint8)
    stem = jve.SmallStem(num_features=16, **kwargs)
    variables = _perturbed(stem.init(jax.random.PRNGKey(2), images), 6)
    ref = np.asarray(stem.apply(variables, images))
    port = ve.SmallStem(num_features=16, **kwargs)
    params = _params(variables)
    assert set(params) == set(port.specs("m"))
    for name, (shape, _) in port.specs("m").items():
        assert tuple(params[name].shape) == tuple(shape), name
    got = port(params, "m", torch.tensor(images))
    assert got.shape[1] == port.num_tokens(size, size) == (
        ref.shape[1] * ref.shape[2])
    np.testing.assert_allclose(got.numpy(), ref.reshape(2, -1, 16), **TOL)


def test_small_stem_at_vit_t_width():
    """The published stem (cnn_channels (32, 96, 192, 384), hidden_dim 64)
    on 224-px frames: 14 x 14 tokens at patch 16, 7 x 7 at patch 32, and
    the flax stem's param count at patch 16 (its init traced, not run)."""
    features = (32, 96, 192, 384)
    for patch, side in ((16, 14), (32, 7)):
        assert ve.SmallStem(patch_size=patch, features=features,
                            num_features=64).num_tokens(224, 224) == side ** 2
    stem = jve.SmallStem(patch_size=16, features=features, num_features=64)
    shapes = jax.eval_shape(stem.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 224, 224, 3), jnp.uint8))["params"]
    ref = {k: v.shape for k, v in from_jax_params(jax.tree_util.tree_map(
        lambda v: np.zeros(v.shape, np.float32), shapes)).items()}
    port = ve.SmallStem(patch_size=16, features=features,
                        num_features=64).specs("m")
    assert {f"m/{k}": tuple(v) for k, v in ref.items()} == {
        k: tuple(shape) for k, (shape, _) in port.items()}
    assert sum(np.prod(s) for s, _ in port.values()) == 884_704


def test_per_sample_conv_matches_vmap():
    """Per-sample generated kernels (B, kh, kw, in, out), as the training
    step's hypernetwork emits them: one grouped convolution against the
    JAX step's vmap of the StdConv over the samples."""
    rng = np.random.RandomState(7)
    batch = 3
    x = rng.randn(batch, 8, 8, 4).astype(np.float32)
    kernels = rng.randn(batch, 3, 3, 4, 6).astype(np.float32)
    biases = rng.randn(batch, 6).astype(np.float32)
    conv = jve.StdConv(features=6, kernel_size=(3, 3), strides=(2, 2),
                       padding=1)

    def one(k, b, xi):
        return conv.apply({"params": {"kernel": k, "bias": b}}, xi[None])[0]

    ref = np.asarray(jax.vmap(one)(kernels, biases, x))
    got = ve.std_conv({"m/kernel": torch.tensor(kernels),
                       "m/bias": torch.tensor(biases)[:, None]}, "m",
                      _nchw(x), 2, 1)
    np.testing.assert_allclose(_nhwc(got), ref, **TOL)


def test_per_sample_small_stem_matches_vmap():
    """The whole stem over per-sample params (each leaf with a leading
    sample axis, biases and norms as per_sample_view lays them out) against
    a vmap of the flax stem."""
    rng = np.random.RandomState(8)
    batch = 2
    images = rng.randint(0, 256, (batch, 32, 32, 3)).astype(np.uint8)
    stem = jve.SmallStem(patch_size=16, num_features=8,
                         features=(32, 32, 32, 32))
    params = [_perturbed(stem.init(jax.random.PRNGKey(i), images[:1]),
                         10 + i)["params"] for i in range(batch)]
    stacked = jax.tree_util.tree_map(lambda *v: np.stack(v), *params)
    ref = np.asarray(jax.vmap(
        lambda p, im: stem.apply({"params": p}, im[None])[0])(
            stacked, images))
    flat = _params({"params": stacked})
    flat = {k: (v if k.endswith("/kernel") else v[:, None])
            for k, v in flat.items()}
    got = ve.SmallStem(patch_size=16, num_features=8,
                       features=(32, 32, 32, 32))(flat, "m",
                                                  torch.tensor(images))
    np.testing.assert_allclose(got.numpy(), ref.reshape(batch, -1, 8),
                               **TOL)


def test_conv_refuses_a_batch_the_kernels_do_not_fit():
    with pytest.raises(ValueError, match="per-sample kernels"):
        layers.conv2d(torch.zeros(3, 2, 4, 4), torch.zeros(2, 1, 1, 2, 2))


def test_standardize_kernel_matches_jnp():
    k = np.random.RandomState(9).randn(2, 3, 3, 4, 5).astype(np.float32)
    ref = k - k.mean(axis=(1, 2, 3), keepdims=True)
    ref = ref / (jnp.std(ref, axis=(1, 2, 3), keepdims=True) + 1e-5)
    np.testing.assert_allclose(
        layers.standardize_kernel(torch.tensor(k)).numpy(), np.asarray(ref),
        **TOL)
