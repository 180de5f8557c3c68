"""Patch encoders of the policy ViT (counterpart of
hypervla_tpu/models/vit_encoders.py): `PatchEncoder`, one strided
convolution, and `SmallStem`, four weight-standardized convolutions with
GroupNorm and ReLU before it (Xiao et al., "Early Convolutions Help
Transformers See Better").

Params keep the JAX package's names (StdConv_<i>, GroupNorm_<i>, embedding)
and layouts: conv kernels stay HWIO in the param dict, because the
hypernetwork generates them as flat HWIO vectors, and are laid out for
torch's convolution at the conv (models/layers.py::conv2d). Activations run
NCHW inside the stem; the tokens come out (B, h * w, features) in the JAX
package's NHWC row-major order. A kernel with a leading sample axis (the
training step's per-sample generated params) runs as one grouped
convolution.

Only what the policy ViT and the hypernetwork build is here: the stems
take the JAX SmallStem's fields (patch_size, kernel_sizes, strides,
features, padding, num_features, learnable_norm) over the default [-1, 1]
image normalization; the policy ViT's use the published stage geometry
(3x3 kernels, stride 2, padding 1, a learnable GroupNorm), the
hypernetwork's goal-image stem (`SmallStem16`, models/hypernetwork.py) a
GroupNorm without scale and bias. FiLM conditioning (`use_film`), the
ResNet stem, the ImageNet normalization and the registry of named variants
are not ported (ROADMAP.md A12, breadth).
"""
import dataclasses
from typing import Dict, Tuple

import torch

from hypervla_tpu_torch.models import layers

def normalize_images(img):
    """uint8 -> [-1, 1] (the JAX function's "default" img_norm_type)."""
    return img.float() * (1.0 / 127.5) - 1.0


def std_conv(params, prefix: str, x, stride: int, padding: int,
             eps: float = 1e-5):
    """StdConv: the kernel under `prefix` standardized per forward (per
    sample where it has a sample axis), then the convolution plus bias."""
    kernel = layers.standardize_kernel(params[f"{prefix}/kernel"], eps)
    return layers.conv2d(x, kernel, params.get(f"{prefix}/bias"), stride,
                         padding)


def _to_tokens(x):
    """NCHW features -> (B, h * w, C) tokens in NHWC row-major order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, x.shape[1])


def _embedding(params, prefix: str, x, patch: int):
    """The strided VALID convolution named `embedding` that every encoder
    here ends with."""
    return layers.conv2d(x, params[f"{prefix}/embedding/kernel"],
                         params[f"{prefix}/embedding/bias"], stride=patch)


def _conv_specs(prefix, size, c_in, c_out):
    return {f"{prefix}/bias": ((c_out,), layers.zeros),
            f"{prefix}/kernel": ((size, size, c_in, c_out),
                                 layers.lecun_normal)}


def _output_side(side: int, kernel: int, stride: int, padding: int) -> int:
    return (side + 2 * padding - kernel) // stride + 1


@dataclasses.dataclass(frozen=True)
class PatchEncoder:
    """normalize -> one strided convolution."""

    patch_size: int = 32
    num_features: int = 512

    def __call__(self, params, prefix: str, images):
        """uint8 (B, H, W, 3) -> tokens (B, n, num_features)."""
        x = normalize_images(images).permute(0, 3, 1, 2)
        return _to_tokens(_embedding(params, prefix, x, self.patch_size))

    def num_tokens(self, height: int, width: int) -> int:
        return (height // self.patch_size) * (width // self.patch_size)

    def specs(self, prefix: str) -> Dict[str, Tuple[tuple, layers.Init]]:
        return _conv_specs(f"{prefix}/embedding", self.patch_size, 3,
                           self.num_features)


@dataclasses.dataclass(frozen=True)
class SmallStem:
    """StdConv + GroupNorm + ReLU per stage (one stage per entry of
    `features`, with its kernel size, stride and padding), then a
    `patch_size // 16` VALID convolution. learnable_norm=False strips the
    GroupNorms' scale and bias."""

    patch_size: int = 32
    kernel_sizes: tuple = (3, 3, 3, 3)
    strides: tuple = (2, 2, 2, 2)
    features: tuple = (32, 96, 192, 384)
    padding: tuple = (1, 1, 1, 1)
    num_features: int = 512
    learnable_norm: bool = True

    def _stages(self):
        return zip(self.kernel_sizes, self.strides, self.features,
                   self.padding)

    def __call__(self, params, prefix: str, images):
        """uint8 (B, H, W, 3) -> tokens (B, n, num_features)."""
        x = normalize_images(images).permute(0, 3, 1, 2)
        for i, (_, stride, _, padding) in enumerate(self._stages()):
            x = std_conv(params, f"{prefix}/StdConv_{i}", x, stride, padding)
            norm = f"{prefix}/GroupNorm_{i}"
            x = torch.relu(layers.group_norm(
                x, params.get(f"{norm}/scale"), params.get(f"{norm}/bias")))
        # the stem downsamples 16x; the patchifier covers the rest
        return _to_tokens(_embedding(params, prefix, x,
                                     self.patch_size // 16))

    def num_tokens(self, height: int, width: int) -> int:
        for kernel, stride, _, padding in self._stages():
            height = _output_side(height, kernel, stride, padding)
            width = _output_side(width, kernel, stride, padding)
        patch = self.patch_size // 16
        return (height // patch) * (width // patch)

    def specs(self, prefix: str) -> Dict[str, Tuple[tuple, layers.Init]]:
        specs = {}
        c_in = 3
        for i, (kernel, _, f, _) in enumerate(self._stages()):
            specs.update(_conv_specs(f"{prefix}/StdConv_{i}", kernel, c_in,
                                     f))
            if self.learnable_norm:
                specs[f"{prefix}/GroupNorm_{i}/bias"] = ((f,), layers.zeros)
                specs[f"{prefix}/GroupNorm_{i}/scale"] = ((f,), layers.ones)
            c_in = f
        specs.update(_conv_specs(f"{prefix}/embedding",
                                 self.patch_size // 16, c_in,
                                 self.num_features))
        return specs
