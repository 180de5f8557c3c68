"""Frame preprocessing (counterpart of hypervla_tpu/ops/preprocess.py and
hypervla_tpu/eval/inference.py::_crop_and_resize_bilinear and
_resize_with_pad): the resizes of serving and of the input pipeline, and
the training augmentations.

Each resize is a separable resampling: one fp32 weight matrix per spatial
axis, built as jax.image builds them (models/encoders/dinov2.py::
scale_translate_weights), applied as two matmuls. torch has no lanczos,
hence the explicit matrices.

The augmentations (dlimp's augment_image: random_resized_crop,
random_brightness, random_contrast, random_saturation, random_hue) work on a
batch (N, H, W, C) of fp32 images in [0, 1], one draw per image, and are
split in two: `sample_augment_params` turns a torch.Generator into the
values of the draws, and each transform takes those values. The JAX
functions draw inside from a key; here a caller may hand in any draws,
JAX's included. The same functions run on CPU tensors in the host pipeline
(data/obs_transforms.py) and on the card inside the train step
(`fused_resize_augment`, train/train_step.py).
"""
import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from hypervla_tpu_torch.models.encoders.dinov2 import (
    KERNELS,
    scale_translate_weights,
)

CROP_SCALE = math.sqrt(0.9)


def _resample(x, wy, wx):
    """x (..., H, W, C) fp32; wy (H, H'), wx (W, W') -> (..., H', W', C)."""
    x = torch.einsum("...hwc,ha->...awc", x, wy)
    return torch.einsum("...awc,wb->...abc", x, wx)


def _to_uint8(x):
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


@functools.lru_cache(maxsize=32)
def _resize_weights(n_in: int, n_out: int, method: str, device):
    """One axis of jax.image.resize (antialiased): the identity where the
    size does not change, as jax resizes only the axes that change. Built
    once for each sizes, method and device: a frame's resize is then two
    matmuls, not ~20 small ops (the host pipeline resizes every frame, the
    serving step every tick). Callers must not write to it."""
    if n_in == n_out:
        return torch.eye(n_in, device=device)
    return scale_translate_weights(n_in, n_out, n_out / n_in, 0.0, method,
                                   True, device, f32_scale=False)


def resize_image(image, size: Tuple[int, int]):
    """Lanczos3 with antialiasing, as jax.image.resize computes it.
    (..., H, W, C) -> uint8 (..., *size, C); same size returns early."""
    h, w = image.shape[-3], image.shape[-2]
    if (h, w) == tuple(size):
        return image.to(torch.uint8)
    dev = image.device
    return _to_uint8(_resample(
        image.float(), _resize_weights(h, size[0], "lanczos3", dev),
        _resize_weights(w, size[1], "lanczos3", dev)))


def resize_depth_image(depth, size: Tuple[int, int]):
    """Lanczos3 with antialiasing of a depth map (..., H, W) -> fp32
    (..., *size), not rounded; same size returns early."""
    h, w = depth.shape[-2], depth.shape[-1]
    if (h, w) == tuple(size):
        return depth.float()
    dev = depth.device
    return _resample(
        depth.float()[..., None], _resize_weights(h, size[0], "lanczos3", dev),
        _resize_weights(w, size[1], "lanczos3", dev))[..., 0]


def resize_with_pad(image, height: int, width: int):
    """tf.image.resize_with_pad as the JAX package computes it: a bilinear
    jax.image.resize that keeps the aspect ratio, zero-padded to (height,
    width) around the centre. (..., H, W, C) -> fp32, not rounded."""
    h, w = image.shape[-3], image.shape[-2]
    scale = min(height / h, width / w)
    new_h, new_w = int(round(h * scale)), int(round(w * scale))
    dev = image.device
    x = _resample(image.float(), _resize_weights(h, new_h, "bilinear", dev),
                  _resize_weights(w, new_w, "bilinear", dev))
    top, left = (height - new_h) // 2, (width - new_w) // 2
    return torch.nn.functional.pad(
        x, (0, 0, left, width - new_w - left, top, height - new_h - top))


def crop_and_resize_bilinear(image, box, size: Tuple[int, int]):
    """tf.image.crop_and_resize for one image and a normalised box
    (y1, x1, y2, x2), as a bilinear scale_and_translate (antialias off).
    image (..., H, W, C) fp32 -> fp32 (..., *size, C)."""
    y1, x1, y2, x2 = box
    h, w = image.shape[-3], image.shape[-2]
    out_h, out_w = size
    scale_y = (y2 - y1) * (h - 1) / max(out_h - 1, 1)
    scale_x = (x2 - x1) * (w - 1) / max(out_w - 1, 1)
    dev = image.device
    wy = scale_translate_weights(h, out_h, 1.0 / scale_y,
                                 -y1 * (h - 1) / scale_y, "bilinear", False,
                                 dev)
    wx = scale_translate_weights(w, out_w, 1.0 / scale_x,
                                 -x1 * (w - 1) / scale_x, "bilinear", False,
                                 dev)
    return _resample(image, wy, wx)


def center_crop(image, size: Tuple[int, int]):
    """The sqrt(0.9) centre crop resized back to `size`, rounded to uint8."""
    offset = (1 - CROP_SCALE) / 2
    box = (offset, offset, offset + CROP_SCALE, offset + CROP_SCALE)
    return _to_uint8(crop_and_resize_bilinear(image.float(), box, size))


# ----------------------------- color utilities -----------------------------


def _rgb_to_hsv(rgb):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    zero = torch.zeros_like(maxc)
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), zero)
    safe_delta = torch.clamp(delta, min=1e-12)
    rc = (maxc - r) / safe_delta
    gc = (maxc - g) / safe_delta
    bc = (maxc - b) / safe_delta
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(delta == 0, zero, h)
    return torch.stack([h, s, maxc], dim=-1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int64), 6)[..., None]
    r = torch.stack([v, q, p, p, t, v], -1).gather(-1, i)[..., 0]
    g = torch.stack([t, v, v, q, p, p], -1).gather(-1, i)[..., 0]
    b = torch.stack([p, p, t, v, v, q], -1).gather(-1, i)[..., 0]
    return torch.stack([r, g, b], dim=-1)


# ------------------------------ augmentations ------------------------------


def _per_image(value, image):
    """A draw of shape (N,) -> (N, 1, 1, 1), fp32 on the image's device."""
    return torch.as_tensor(value, dtype=torch.float32,
                           device=image.device).reshape(-1, 1, 1, 1)


def _crop_weights(in_size: int, scale, translation):
    """Batched jax compute_weight_mat for the antialiased bilinear
    (triangle) kernel, with fp32 per-image scale and translation (N,) ->
    (N, in_size, in_size)."""
    f32 = torch.float32
    dev = scale.device
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    pos = torch.arange(in_size, dtype=f32, device=dev)
    sample_f = ((pos[None, :] + 0.5) * inv_scale[:, None]
                - (translation * inv_scale)[:, None] - 0.5)
    x = (sample_f[:, None, :] - pos[None, :, None]).abs()
    weights = KERNELS["bilinear"](x / kernel_scale[:, None, None])
    total = weights.sum(1, keepdim=True)
    eps = 1000.0 * float(torch.finfo(f32).eps)
    weights = torch.where(
        total.abs() > eps,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None, :], weights, torch.zeros_like(weights))


def random_resized_crop(image, area, log_ratio, u_x, u_y):
    """Crops the area fraction `area` at aspect exp(`log_ratio`), offset by
    the fractions u_x, u_y of the slack, and resizes it back (jax's
    scale_and_translate, bilinear, antialiased: a triangle widened by the
    scale where it shrinks). image (N, H, W, C) fp32 in [0, 1]; each draw
    (N,)."""
    h, w = image.shape[-3], image.shape[-2]
    dev = image.device
    area, log_ratio, u_x, u_y = (
        torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(-1)
        for v in (area, log_ratio, u_x, u_y))
    aspect = torch.exp(log_ratio)
    target_area = area * h * w
    cut_h = torch.clamp(torch.sqrt(target_area / aspect), 1.0, h)
    cut_w = torch.clamp(torch.sqrt(target_area * aspect), 1.0, w)
    off_y = u_y * (h - cut_h)
    off_x = u_x * (w - cut_w)
    # a true division: torch's `int / tensor` multiplies by a reciprocal
    scale_y = torch.full_like(cut_h, h) / cut_h
    scale_x = torch.full_like(cut_w, w) / cut_w
    wy = _crop_weights(h, scale_y, -off_y * scale_y)
    wx = _crop_weights(w, scale_x, -off_x * scale_x)
    out = torch.einsum("nhwc,nha->nawc", image, wy)
    out = torch.einsum("nawc,nwb->nabc", out, wx)
    return torch.clamp(out, 0.0, 1.0)


def random_brightness(image, delta):
    return torch.clamp(image + _per_image(delta, image), 0.0, 1.0)


def random_contrast(image, factor):
    mean = image.mean(dim=(-3, -2, -1), keepdim=True)
    return torch.clamp((image - mean) * _per_image(factor, image) + mean,
                       0.0, 1.0)


def random_saturation(image, factor):
    gray = image.mean(dim=-1, keepdim=True)
    return torch.clamp(gray + (image - gray) * _per_image(factor, image),
                       0.0, 1.0)


def random_hue(image, delta):
    hsv = _rgb_to_hsv(image)
    hue = torch.remainder(hsv[..., 0] + _per_image(delta, image)[..., 0],
                          1.0)
    hsv = torch.cat([hue[..., None], hsv[..., 1:]], dim=-1)
    return torch.clamp(_hsv_to_rgb(hsv), 0.0, 1.0)


_AUGMENT_OPS = {
    "random_resized_crop": lambda img, d: random_resized_crop(
        img, d["area"], d["log_ratio"], d["x"], d["y"]),
    "random_brightness": lambda img, d: random_brightness(img, d["delta"]),
    "random_contrast": lambda img, d: random_contrast(img, d["factor"]),
    "random_saturation": lambda img, d: random_saturation(img, d["factor"]),
    "random_hue": lambda img, d: random_hue(img, d["delta"]),
}


def _uniform(n: int, lo, hi, generator, device):
    """jax.random.uniform's map of [0, 1) floats onto [lo, hi), in fp32."""
    f32 = torch.float32
    lo = torch.as_tensor(lo, dtype=f32, device=device)
    hi = torch.as_tensor(hi, dtype=f32, device=device)
    u = torch.rand(n, generator=generator, device=device, dtype=f32)
    return torch.maximum(lo, u * (hi - lo) + lo)


def sample_augment_params(n: int, augment_order: Sequence[str],
                          generator: torch.Generator, **kwargs
                          ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The draws of `augment_image` for n images, on the generator's
    device: {op: {name: (n,) fp32}}, in the ranges the JAX ops draw from
    (random_resized_crop: area in scale, log aspect in log(ratio), offsets
    x, y in [0, 1); brightness and hue: delta in [-d, d]; contrast and
    saturation: factor in [lo, hi])."""
    dev = generator.device

    def draw(lo, hi):
        return _uniform(n, lo, hi, generator, dev)

    params = {}
    for op in augment_order:
        kw = kwargs[op]
        if op == "random_resized_crop":
            ratio = torch.log(torch.tensor(kw["ratio"], dtype=torch.float32))
            params[op] = {"area": draw(kw["scale"][0], kw["scale"][1]),
                          "log_ratio": draw(ratio[0], ratio[1]),
                          "x": draw(0.0, 1.0), "y": draw(0.0, 1.0)}
        elif op in ("random_brightness", "random_hue"):
            params[op] = {"delta": draw(-kw[0], kw[0])}
        elif op in ("random_contrast", "random_saturation"):
            params[op] = {"factor": draw(kw[0], kw[1])}
        else:
            raise ValueError(f"unknown augmentation {op!r}")
    return params


def augment_image(image, params, augment_order: Sequence[str], **kwargs):
    """Applies the augmentations of augment_order with the draws `params`
    (sample_augment_params). image (N, H, W, C) or (H, W, C), uint8 (then
    returned as uint8, rounded) or float in [0, 1]. `kwargs` holds the
    ranges, which only the draws read."""
    del kwargs
    single = image.dim() == 3
    x = image[None] if single else image
    was_uint8 = x.dtype == torch.uint8
    x = x.float()
    if was_uint8:
        x = x / 255.0
    for op in augment_order:
        x = _AUGMENT_OPS[op](x, params[op])
    if was_uint8:
        x = _to_uint8(x * 255.0)
    return x[0] if single else x


def rtx_pad_crop(image, off_y: int, off_x: int):
    """The "rtx" style crop: a 256x320 frame (H, W, C) padded by (20, 50)
    with zeros, cropped back to 256x320 at (off_y, off_x), each drawn from
    [0, 40] and [0, 100] (`sample_rtx_offsets`)."""
    ud_pad, lr_pad = 20, 50
    h, w = 256, 320
    padded = torch.nn.functional.pad(
        image, (0, 0, lr_pad, lr_pad, ud_pad, ud_pad))
    return padded[off_y:off_y + h, off_x:off_x + w]


def sample_rtx_offsets(generator: torch.Generator) -> Tuple[int, int]:
    off_y = torch.randint(0, 41, (), generator=generator)
    off_x = torch.randint(0, 101, (), generator=generator)
    return int(off_y), int(off_x)


def fused_resize_augment(images, resize_size: Tuple[int, int],
                         augment_kwargs: Optional[dict] = None,
                         train: bool = True, params=None,
                         generator: Optional[torch.Generator] = None):
    """The batched lanczos3 resize and, at train time, the augmentation
    chain, one draw per image: images (B, H, W, C) uint8 -> uint8 (B,
    *resize_size, C). The draws are `params`, or else drawn from
    `generator`."""
    images = resize_image(images, tuple(resize_size))
    if not (train and augment_kwargs):
        return images
    if params is None:
        params = sample_augment_params(images.shape[0],
                                       generator=generator, **augment_kwargs)
    return augment_image(images, params, **augment_kwargs)
