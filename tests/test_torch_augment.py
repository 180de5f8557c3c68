"""The port's training augmentations (hypervla_tpu_torch/ops/preprocess.py)
against the JAX package's (hypervla_tpu/ops/preprocess.py) on the CPU.

The JAX functions draw inside from a key; the port's take the drawn
values. Each test draws them with jax.random, splitting the key the way the
JAX function splits it (`_jax_draws`), and hands them to the port: the same
draws, so the functions must agree. fp32 outputs to 1e-5; uint8 outputs
within one level (a .5 after fp32 rounding may round either way).

The references run op by op, the JAX source's own arithmetic, which the
port follows to ~1e-7. Under jit XLA's CPU backend contracts and rewrites
the crop's fp32 sample positions (an FMA, a reassociated scale), which
moves a 224-wide crop by up to ~4e-5 against the same function run op by
op: JAX against itself. `fused_resize_augment`, jitted inside the JAX
package, is held at its uint8 output."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervla_tpu.ops import preprocess as jpre
from hypervla_tpu_torch.ops import preprocess as pre
from test_torch_harness import torch_threads  # noqa: F401

CHAIN = dict(
    augment_order=["random_resized_crop", "random_brightness",
                   "random_contrast", "random_saturation", "random_hue"],
    random_resized_crop=dict(scale=[0.8, 1.0], ratio=[0.9, 1.1]),
    random_brightness=[0.1],
    random_contrast=[0.9, 1.1],
    random_saturation=[0.9, 1.1],
    random_hue=[0.05],
)
#: a wider crop, so that the crop both shrinks and enlarges along an axis
WIDE_CROP = dict(scale=[0.3, 1.0], ratio=[0.5, 2.0])
SIZES = [(64, 64), (224, 224)]


def _uniform(key, lo, hi):
    return float(jax.random.uniform(key, (), minval=lo, maxval=hi))


def _jax_op_draws(op, key, kw):
    """The values the JAX op `op` draws from `key`."""
    if op == "random_resized_crop":
        k_area, k_ratio, k_x, k_y = jax.random.split(key, 4)
        return {"area": _uniform(k_area, kw["scale"][0], kw["scale"][1]),
                "log_ratio": _uniform(k_ratio, jnp.log(kw["ratio"][0]),
                                      jnp.log(kw["ratio"][1])),
                "x": _uniform(k_x, 0.0, 1.0), "y": _uniform(k_y, 0.0, 1.0)}
    if op in ("random_brightness", "random_hue"):
        return {"delta": _uniform(key, -kw[0], kw[0])}
    return {"factor": _uniform(key, kw[0], kw[1])}


def _jax_draws(key, augment_order, **kwargs):
    """augment_image's draws for one image, as (1,) tensors."""
    keys = jax.random.split(key, len(augment_order))
    return {op: {k: torch.tensor([v], dtype=torch.float32)
                 for k, v in _jax_op_draws(op, k, kwargs[op]).items()}
            for op, k in zip(augment_order, keys)}


def _stack(draws):
    return {op: {k: torch.cat([d[op][k] for d in draws])
                 for k in draws[0][op]} for op in draws[0]}


def _image(size, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (*size, 3)).astype(np.uint8)
    # flat patches and gray pixels: hue's delta == 0 and max-channel ties
    img[: size[0] // 4, : size[1] // 4] = 128
    img[-8:, -8:, 1] = img[-8:, -8:, 0]
    return img if dtype == np.uint8 else (img / 255.0).astype(np.float32)


def _close(got, ref, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol,
                               rtol=0)


def _within_one_level(got, ref):
    diff = np.abs(np.asarray(got).astype(np.int32)
                  - np.asarray(ref).astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < 1e-3, (diff > 0).mean()


OPS = [
    ("random_resized_crop", CHAIN["random_resized_crop"],
     lambda img, key, kw: jpre.random_resized_crop(img, key, kw["scale"],
                                                   kw["ratio"])),
    ("random_resized_crop", WIDE_CROP,
     lambda img, key, kw: jpre.random_resized_crop(img, key, kw["scale"],
                                                   kw["ratio"])),
    ("random_brightness", [0.3],
     lambda img, key, kw: jpre.random_brightness(img, key, kw[0])),
    ("random_contrast", [0.5, 1.5],
     lambda img, key, kw: jpre.random_contrast(img, key, kw[0], kw[1])),
    ("random_saturation", [0.5, 1.5],
     lambda img, key, kw: jpre.random_saturation(img, key, kw[0], kw[1])),
    ("random_hue", [0.3],
     lambda img, key, kw: jpre.random_hue(img, key, kw[0])),
]


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("op,kw,jax_fn", OPS,
                         ids=[f"{o[0]}{i}" for i, o in enumerate(OPS)])
def test_op_matches_jax_on_its_draws(op, kw, jax_fn, size):
    for seed in range(3):
        img = _image(size, seed)
        key = jax.random.PRNGKey(100 + seed)
        ref = jax_fn(jnp.asarray(img), key, kw)
        draws = {k: torch.tensor([v], dtype=torch.float32)
                 for k, v in _jax_op_draws(op, key, kw).items()}
        got = pre._AUGMENT_OPS[op](torch.tensor(img)[None], draws)[0]
        _close(got, ref)


def test_hsv_round_trip_matches_jax():
    rgb = _image((32, 32), 7)
    rgb[0, :4] = [[0, 0, 0], [1, 1, 1], [1, 0, 0], [0.5, 0.5, 0.2]]
    hsv = pre._rgb_to_hsv(torch.tensor(rgb))
    _close(hsv, jpre._rgb_to_hsv(jnp.asarray(rgb)))
    _close(pre._hsv_to_rgb(hsv), jpre._hsv_to_rgb(jnp.asarray(hsv.numpy())))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("dtype", [np.uint8, np.float32],
                         ids=["uint8", "float"])
def test_augment_image_matches_jax(size, dtype):
    for seed in range(2):
        img = _image(size, seed, dtype)
        key = jax.random.PRNGKey(seed)
        ref = jpre.augment_image(jnp.asarray(img), key, **CHAIN)
        params = _jax_draws(key, **CHAIN)
        got = pre.augment_image(torch.tensor(img), params, **CHAIN)
        assert got.shape == ref.shape
        if dtype == np.uint8:
            assert got.dtype == torch.uint8
            _within_one_level(got, ref)
        else:
            _close(got, ref)


def test_augment_image_batches_per_image_draws():
    """A batch with one draw per image equals each image alone."""
    imgs = np.stack([_image((64, 64), s) for s in range(3)])
    draws = [_jax_draws(jax.random.PRNGKey(s), **CHAIN) for s in range(3)]
    batch = pre.augment_image(torch.tensor(imgs), _stack(draws), **CHAIN)
    for i in range(3):
        alone = pre.augment_image(torch.tensor(imgs[i]), draws[i], **CHAIN)
        _close(batch[i], alone, atol=1e-6)


@pytest.mark.parametrize("in_size,out_size", [((80, 96), (64, 64)),
                                              ((256, 256), (224, 224))])
def test_fused_resize_augment_matches_jax(in_size, out_size):
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (3, *in_size, 3)).astype(np.uint8)
    key = jax.random.PRNGKey(11)
    ref = jpre.fused_resize_augment(jnp.asarray(imgs), key, out_size,
                                    dict(CHAIN), train=True)
    params = _stack([_jax_draws(k, **CHAIN)
                     for k in jax.random.split(key, len(imgs))])
    got = pre.fused_resize_augment(torch.tensor(imgs), out_size, dict(CHAIN),
                                   params=params)
    assert got.shape == (3, *out_size, 3) and got.dtype == torch.uint8
    # a pixel the resize rounds one level apart may move a level more
    diff = np.abs(got.numpy().astype(np.int32) - np.asarray(ref, np.int32))
    assert diff.max() <= 2 and (diff > 0).mean() < 1e-2, diff.max()
    # without training it is the resize alone
    plain = pre.fused_resize_augment(torch.tensor(imgs), out_size,
                                     dict(CHAIN), train=False)
    jplain = jpre.fused_resize_augment(jnp.asarray(imgs), key, out_size,
                                       dict(CHAIN), train=False)
    _within_one_level(plain, jplain)


def test_rtx_pad_crop_matches_jax():
    img = _image((256, 320), 4, np.uint8)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        k_y, k_x = jax.random.split(key)
        off_y = int(jax.random.randint(k_y, (), 0, 41))
        off_x = int(jax.random.randint(k_x, (), 0, 101))
        ref = jpre.rtx_pad_crop(jnp.asarray(img), key)
        got = pre.rtx_pad_crop(torch.tensor(img), off_y, off_x)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_sample_augment_params_ranges_and_repeat():
    """The port's own draws: in the JAX ops' ranges, one per image, the
    same under the same seed."""
    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return pre.sample_augment_params(500, generator=gen, **CHAIN)

    a, b, c = draw(0), draw(0), draw(1)
    crop = a["random_resized_crop"]
    assert crop["area"].shape == (500,)
    assert 0.8 <= crop["area"].min() and crop["area"].max() < 1.0
    assert (np.log(0.9) - 1e-6 <= crop["log_ratio"].min()
            and crop["log_ratio"].max() < np.log(1.1) + 1e-6)
    assert 0.0 <= crop["x"].min() and crop["y"].max() < 1.0
    assert a["random_brightness"]["delta"].abs().max() <= 0.1
    assert a["random_hue"]["delta"].abs().max() <= 0.05
    for op in ("random_contrast", "random_saturation"):
        assert 0.9 <= a[op]["factor"].min() and a[op]["factor"].max() < 1.1
    for op in a:
        for k in a[op]:
            assert torch.equal(a[op][k], b[op][k])
            assert not torch.equal(a[op][k], c[op][k])
    with pytest.raises(ValueError, match="unknown augmentation"):
        pre.sample_augment_params(1, ["random_blur"],
                                  torch.Generator(), random_blur=[1])
