"""Frame preprocessing for serving (counterpart of
hypervla_tpu/ops/preprocess.py::resize_image and
hypervla_tpu/eval/inference.py::_crop_and_resize_bilinear and
_resize_with_pad).

Each is a separable resampling: one fp32 weight matrix per spatial axis,
built as jax.image builds them (models/encoders/dinov2.py::
scale_translate_weights), applied as two matmuls. torch has no lanczos,
hence the explicit matrices.
"""
import math
from typing import Tuple

import torch

from hypervla_tpu_torch.models.encoders.dinov2 import scale_translate_weights

CROP_SCALE = math.sqrt(0.9)


def _resample(x, wy, wx):
    """x (..., H, W, C) fp32; wy (H, H'), wx (W, W') -> (..., H', W', C)."""
    x = torch.einsum("...hwc,ha->...awc", x, wy)
    return torch.einsum("...awc,wb->...abc", x, wx)


def _to_uint8(x):
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def _resize_weights(n_in: int, n_out: int, method: str, device):
    """One axis of jax.image.resize (antialiased): the identity where the
    size does not change, as jax resizes only the axes that change."""
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
