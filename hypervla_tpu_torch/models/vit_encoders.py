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
`<prefix>/FilmConditioning_0`.

`ViTResnet` is the ResNet-v2 hybrid stem of the ViT paper: a 7x7 stride-2
StdConv, GroupNorm, ReLU and a 3x3 stride-2 max pool, then stages of
bottleneck `ResidualUnit`s (block<i>/unit<j>/{conv1, gn1, conv2, gn2,
conv3, gn3, conv_proj, gn_proj}), FiLM-conditioned after every stage but
the first with use_film (FilmConditioning_<k>); `ResNet26FILM` and the
registry's resnetv2-26-film / resnetv2-50-film. Its convolutions and the
max pool pad as XLA's "SAME" does (the odd pixel on the high side, the
pool's padding -inf). img_norm_type "imagenet" normalizes with the
ImageNet mean and std, tiled over stacked frames.
"""
import dataclasses
import functools as ft
from typing import Dict, Optional, Tuple

import torch

from hypervla_tpu_torch.models import layers
from hypervla_tpu_torch.models.film import film_conditioning, film_specs

FILM = "FilmConditioning_0"


IMAGENET_STATS = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


def normalize_images(img, img_norm_type: str = "default"):
    """"default": uint8 -> [-1, 1]. "imagenet": the ImageNet mean and std
    per channel, tiled over stacked frames (a channel count that is a
    multiple of 3; AssertionError otherwise)."""
    if img_norm_type == "default":
        return img.float() * (1.0 / 127.5) - 1.0
    if img_norm_type == "imagenet":
        frames = img.shape[-1] // 3
        assert img.shape[-1] == 3 * frames, "images should have rgb channels!"
        mean, std = (torch.tensor(s, dtype=torch.float32,
                                  device=img.device).repeat(frames)
                     for s in IMAGENET_STATS)
        return (img.float() / 255 - mean) / std
    raise ValueError(f"unknown img_norm_type {img_norm_type}")


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


def std_conv(params, prefix: str, x, stride: int, padding,
             eps: float = 1e-5):
    """StdConv: the kernel under `prefix` standardized per forward (per
    sample where it has a sample axis), then the convolution plus bias.
    padding: p pixels on every side, or "SAME" (XLA's)."""
    kernel = layers.standardize_kernel(params[f"{prefix}/kernel"], eps)
    if padding == "SAME":
        x = layers.pad_same(x, kernel.shape[-4], kernel.shape[-3], stride)
        padding = 0
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


def _gn(params, prefix, x):
    return layers.group_norm(x, params[f"{prefix}/scale"],
                             params[f"{prefix}/bias"])


def _gn_specs(prefix, channels, scale=layers.ones):
    return {f"{prefix}/bias": ((channels,), layers.zeros),
            f"{prefix}/scale": ((channels,), scale)}


def _std_conv_specs(prefix, size, c_in, c_out):
    return {f"{prefix}/kernel": ((size, size, c_in, c_out),
                                 layers.lecun_normal)}


@dataclasses.dataclass(frozen=True)
class ResidualUnit:
    """ResNet-v2 bottleneck: 1x1 -> 3x3 (stride) -> 1x1 (4 * features),
    GroupNorm after each convolution (the last one's scale starts at 0),
    a projected shortcut where the shape changes."""

    features: int
    strides: Tuple[int, int] = (1, 1)

    def _projects(self, c_in: int) -> bool:
        return tuple(self.strides) != (1, 1) or c_in != 4 * self.features

    def __call__(self, params, prefix: str, x):
        stride = self.strides[0]
        shortcut = x
        if self._projects(x.shape[1]):
            shortcut = _gn(params, f"{prefix}/gn_proj", std_conv(
                params, f"{prefix}/conv_proj", x, stride, "SAME"))
        y = x
        for tag, s in (("1", 1), ("2", stride), ("3", 1)):
            y = _gn(params, f"{prefix}/gn{tag}", std_conv(
                params, f"{prefix}/conv{tag}", y, s, "SAME"))
            if tag != "3":
                y = torch.relu(y)
        return torch.relu(shortcut + y)

    def specs(self, prefix: str, c_in: int):
        f = self.features
        specs = {}
        if self._projects(c_in):
            specs.update(_std_conv_specs(f"{prefix}/conv_proj", 1, c_in,
                                         4 * f))
            specs.update(_gn_specs(f"{prefix}/gn_proj", 4 * f))
        for tag, size, fin, fout in (("1", 1, c_in, f), ("2", 3, f, f),
                                     ("3", 1, f, 4 * f)):
            specs.update(_std_conv_specs(f"{prefix}/conv{tag}", size, fin,
                                         fout))
            specs.update(_gn_specs(f"{prefix}/gn{tag}", fout,
                                   layers.zeros if tag == "3"
                                   else layers.ones))
        return specs


def _stage_units(block_size: int, nout: int, first_stride):
    return [ResidualUnit(nout, tuple(first_stride) if i == 0 else (1, 1))
            for i in range(block_size)]


def max_pool_same(x, window: int, stride: int):
    """flax's nn.max_pool with padding "SAME" on NCHW: -inf padding, the
    odd pixel on the high side."""
    x = layers.pad_same(x, window, window, stride, value=float("-inf"))
    return torch.nn.functional.max_pool2d(x, window, stride)


@dataclasses.dataclass(frozen=True)
class ViTResnet:
    """The ResNet-v2 hybrid stem of the original ViT paper; the features
    come out as tokens (B, h * w, C) in NHWC row-major order."""

    use_film: bool = False
    width: int = 1
    num_layers: tuple = tuple()
    img_norm_type: str = "default"

    @property
    def root_width(self) -> int:
        return int(64 * self.width)

    @property
    def num_features(self) -> int:
        if not self.num_layers:
            return self.root_width
        return 4 * self.root_width * 2 ** (len(self.num_layers) - 1)

    def __call__(self, params, prefix: str, observations, cond_var=None):
        """uint8 (B, H, W, C) -> tokens (B, n, num_features); cond_var
        (B, D), the FiLM conditioning, exactly when use_film."""
        assert self.use_film == (cond_var is not None), (
            "pass cond_var iff use_film")
        x = normalize_images(observations, self.img_norm_type).permute(
            0, 3, 1, 2)
        x = std_conv(params, f"{prefix}/conv_root", x, 2, "SAME")
        x = torch.relu(_gn(params, f"{prefix}/gn_root", x))
        x = max_pool_same(x, 3, 2)
        film = 0
        for i, block_size in enumerate(self.num_layers):
            units = _stage_units(block_size, self.root_width * 2 ** i,
                                 (1, 1) if i == 0 else (2, 2))
            for j, unit in enumerate(units):
                x = unit(params, f"{prefix}/block{i + 1}/unit{j + 1}", x)
            if self.use_film and i > 0:
                x = film_conditioning(
                    params, f"{prefix}/FilmConditioning_{film}", x, cond_var)
                film += 1
        if self.use_film and not self.num_layers:
            x = film_conditioning(params, f"{prefix}/FilmConditioning_0", x,
                                  cond_var)
        return _to_tokens(x)

    def num_tokens(self, height: int, width: int) -> int:
        def side(n):
            n = -(-n // 2)  # the root convolution
            n = -(-n // 2)  # the max pool
            return n if not self.num_layers else (
                -(-n // 2 ** (len(self.num_layers) - 1)))
        return side(height) * side(width)

    def specs(self, prefix: str, in_channels: int = 3,
              cond_dim: Optional[int] = None
              ) -> Dict[str, Tuple[tuple, layers.Init]]:
        width = self.root_width
        specs = _std_conv_specs(f"{prefix}/conv_root", 7, in_channels, width)
        specs.update(_gn_specs(f"{prefix}/gn_root", width))
        c_in, film = width, 0
        for i, block_size in enumerate(self.num_layers):
            units = _stage_units(block_size, width * 2 ** i,
                                 (1, 1) if i == 0 else (2, 2))
            for j, unit in enumerate(units):
                specs.update(unit.specs(f"{prefix}/block{i + 1}/unit{j + 1}",
                                        c_in))
                c_in = 4 * unit.features
            if self.use_film and i > 0:
                if not cond_dim:
                    raise ValueError("a FiLM stem's specs need the "
                                     "conditioning width (cond_dim)")
                specs.update(film_specs(f"{prefix}/FilmConditioning_{film}",
                                        cond_dim, c_in))
                film += 1
        if self.use_film and not self.num_layers:
            specs.update(_film_specs(self, prefix, cond_dim, c_in))
        return specs


@dataclasses.dataclass(frozen=True)
class ResNet26FILM(ViTResnet):
    use_film: bool = True
    num_layers: tuple = (2, 2, 2, 2)


def _build_encoder_registry():
    """The JAX package's named variants (hypervla_tpu/models/
    vit_encoders.py::_build_encoder_registry)."""
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
    for depth, num_layers in ((26, (2, 2, 2, 2)), (50, (3, 4, 6, 3))):
        registry[f"resnetv2-{depth}-film"] = ft.partial(
            ViTResnet, use_film=True, num_layers=num_layers)
    return registry


vit_encoder_configs = _build_encoder_registry()
