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

The stems take the JAX fields (use_film, patch_size, kernel_sizes,
strides, features, padding, num_features, img_norm_type, learnable_norm):
the policy ViT's use the published stage geometry (3x3 kernels, stride 2,
padding 1, a learnable GroupNorm), the hypernetwork's goal-image stem
(models/hypernetwork.py) a GroupNorm without scale and bias, and the Octo
topology's ImageTokenizer (models/tokenizers.py) any of them by name,
`SmallStem16` or a `vit_encoder_configs` variant, over 3 channels a
stacked frame. With use_film the stem's output is FiLM-conditioned
(models/film.py) on the `cond_var` it is given, under
`<prefix>/FilmConditioning_0`. The ResNet stem (ViTResnet, and the
registry's resnetv2 variants) and the "imagenet" img_norm_type are not
ported yet (ROADMAP.md A12.2, second half): the latter raises.
"""
import dataclasses
import functools as ft
from typing import Dict, Optional, Tuple

import torch

from hypervla_tpu_torch.models import layers
from hypervla_tpu_torch.models.film import film_conditioning, film_specs

FILM = "FilmConditioning_0"


def normalize_images(img, img_norm_type: str = "default"):
    """uint8 -> [-1, 1] (the JAX function's "default" img_norm_type)."""
    if img_norm_type != "default":
        raise NotImplementedError(
            f"img_norm_type {img_norm_type!r}: only 'default' is ported "
            "(ROADMAP.md A12.2, second half)")
    return img.float() * (1.0 / 127.5) - 1.0


def _film(stem, params, prefix, x, cond_var):
    """The stem's FiLM on NCHW features where it has one; cond_var must be
    given exactly when use_film is set."""
    assert stem.use_film == (cond_var is not None), (
        "pass cond_var iff use_film")
    if cond_var is None:
        return x
    return film_conditioning(params, f"{prefix}/{FILM}", x, cond_var)


def _film_specs(stem, prefix, cond_dim, channels):
    if not stem.use_film:
        return {}
    if not cond_dim:
        raise ValueError("a FiLM stem's specs need the conditioning width "
                         "(cond_dim)")
    return film_specs(f"{prefix}/{FILM}", cond_dim, channels)


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
    use_film: bool = False
    img_norm_type: str = "default"

    def __call__(self, params, prefix: str, images, cond_var=None):
        """uint8 (B, H, W, C) -> tokens (B, n, num_features); cond_var
        (B, D), the FiLM conditioning, exactly when use_film."""
        x = normalize_images(images, self.img_norm_type).permute(0, 3, 1, 2)
        x = _embedding(params, prefix, x, self.patch_size)
        return _to_tokens(_film(self, params, prefix, x, cond_var))

    def num_tokens(self, height: int, width: int) -> int:
        return (height // self.patch_size) * (width // self.patch_size)

    def specs(self, prefix: str, in_channels: int = 3,
              cond_dim: Optional[int] = None
              ) -> Dict[str, Tuple[tuple, layers.Init]]:
        specs = _conv_specs(f"{prefix}/embedding", self.patch_size,
                            in_channels, self.num_features)
        specs.update(_film_specs(self, prefix, cond_dim, self.num_features))
        return specs


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
    use_film: bool = False
    img_norm_type: str = "default"

    def _stages(self):
        return zip(self.kernel_sizes, self.strides, self.features,
                   self.padding)

    def __call__(self, params, prefix: str, images, cond_var=None):
        """uint8 (B, H, W, C) -> tokens (B, n, num_features); cond_var
        (B, D), the FiLM conditioning, exactly when use_film."""
        assert self.use_film == (cond_var is not None), (
            "pass cond_var iff use_film")
        x = normalize_images(images, self.img_norm_type).permute(0, 3, 1, 2)
        for i, (_, stride, _, padding) in enumerate(self._stages()):
            x = std_conv(params, f"{prefix}/StdConv_{i}", x, stride, padding)
            norm = f"{prefix}/GroupNorm_{i}"
            x = torch.relu(layers.group_norm(
                x, params.get(f"{norm}/scale"), params.get(f"{norm}/bias")))
        # the stem downsamples 16x; the patchifier covers the rest
        x = _embedding(params, prefix, x, self.patch_size // 16)
        return _to_tokens(_film(self, params, prefix, x, cond_var))

    def num_tokens(self, height: int, width: int) -> int:
        for kernel, stride, _, padding in self._stages():
            height = _output_side(height, kernel, stride, padding)
            width = _output_side(width, kernel, stride, padding)
        patch = self.patch_size // 16
        return (height // patch) * (width // patch)

    def specs(self, prefix: str, in_channels: int = 3,
              cond_dim: Optional[int] = None
              ) -> Dict[str, Tuple[tuple, layers.Init]]:
        specs = {}
        c_in = in_channels
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
        specs.update(_film_specs(self, prefix, cond_dim, self.num_features))
        return specs


@dataclasses.dataclass(frozen=True)
class SmallStem16(SmallStem):
    patch_size: int = 16


def _build_encoder_registry():
    """The JAX package's named variants (hypervla_tpu/models/
    vit_encoders.py::_build_encoder_registry), but the ResNet ones."""
    registry = {}
    for ps in (16, 32):
        registry[f"patchify-{ps}-film"] = ft.partial(
            PatchEncoder, use_film=True, patch_size=ps)
        registry[f"small-stem-{ps}-film"] = ft.partial(
            SmallStem, use_film=True, patch_size=ps)
    registry["small-stem-16"] = ft.partial(SmallStem, patch_size=16)
    # 3-stage stem: downsamples 8x before the patchifier
    registry["small-stem-8-film"] = ft.partial(
        SmallStem, use_film=True, patch_size=16, kernel_sizes=(3,) * 3,
        strides=(2,) * 3, features=(32, 96, 192), padding=(1,) * 3)
    return registry


vit_encoder_configs = _build_encoder_registry()
