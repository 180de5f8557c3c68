"""The 1-D conditional U-Net score network of the U-Net DDPM action head
(counterpart of hypervla_tpu/models/unet.py).

Over the action chunk's horizon axis, conditioned on the observation
embedding and the diffusion time: two FiLM residual blocks a level, a
stride-2 convolution down between levels, the mid blocks, then the
mirrored levels up, each fed the skip of the level below it, ending in a
stride-2 transposed convolution; a last conv -> GroupNorm -> mish.

Activations stay (..., length, channels) as in the JAX package; a
convolution runs torch's conv1d over the leading axes flattened, with the
JAX paddings ("SAME" as lax computes it; the transposed convolution as
lax.conv_transpose: the input dilated by the stride, padded (2, 2) for
kernel 4, cross-correlated). The GroupNorm takes its statistics per
sample over every axis but the first (flax's reduction), each group's
channels together. Params keep the flax names (time_mlp_<i>,
encoder_<level>_<block>, downsamplers_<i>, bottleneck_<i>,
decoder_<level>_<block>, upsamplers_<i>, out_proj) and layouts (conv
kernels (k, in, out)).
"""
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from hypervla_tpu_torch.models import layers
from hypervla_tpu_torch.models.diffusion import unet_squaredcos_cap_v2

__all__ = ["mish", "unet_squaredcos_cap_v2", "fourier_time_embedding",
           "ConditionalUnet1D"]


def mish(x):
    return x * torch.tanh(F.softplus(x))


def fourier_time_embedding(t, features: int):
    """sin and cos (half each) of the timesteps t (..., 1)."""
    half = features // 2
    freqs = torch.exp(-torch.log(torch.tensor(10000.0, device=t.device))
                      * torch.arange(half, device=t.device).float()
                      / (half - 1))
    phases = t.float() * freqs
    return torch.cat([torch.sin(phases), torch.cos(phases)], dim=-1)


def _same_pads(length: int, kernel: int, stride: int):
    out = -(-length // stride)
    total = max((out - 1) * stride + kernel - length, 0)
    return total // 2, total - total // 2


def conv1d(x, kernel, bias, stride: int = 1, padding="SAME",
           transpose: bool = False):
    """flax nn.Conv / nn.ConvTranspose over x (..., length, in) with an
    (k, in, out) kernel; padding an int p ([(p, p)]) or "SAME"."""
    *lead, length, c_in = x.shape
    h = x.reshape(-1, length, c_in).transpose(1, 2)
    k = kernel.shape[0]
    w = kernel.permute(2, 1, 0)
    if transpose:
        dilated = h.new_zeros(h.shape[0], c_in, (length - 1) * stride + 1)
        dilated[..., ::stride] = h
        pad_len = k + stride - 2
        lo = k - 1 if stride > k - 1 else math.ceil(pad_len / 2)
        h = F.pad(dilated, (lo, pad_len - lo))
        y = F.conv1d(h, w)
    else:
        pads = ((padding, padding) if isinstance(padding, int)
                else _same_pads(length, k, stride))
        y = F.conv1d(F.pad(h, pads), w, stride=stride)
    y = y + bias[:, None]
    return y.transpose(1, 2).reshape(*lead, y.shape[-1], y.shape[1])


def group_norm(x, scale, bias, num_groups: int, eps: float = 1e-6):
    """flax nn.GroupNorm over x (B, ..., C): statistics per sample and
    group over every other axis, in fp32, with the fast variance."""
    b, c = x.shape[0], x.shape[-1]
    g = x.float().reshape(b, -1, num_groups, c // num_groups)
    mu = g.mean((1, 3), keepdim=True)
    var = torch.clamp((g * g).mean((1, 3), keepdim=True) - mu * mu, min=0.0)
    y = ((g - mu) * torch.rsqrt(var + eps)).reshape(x.shape)
    return y * scale + bias


def _conv_specs(prefix, k, c_in, c_out):
    return {f"{prefix}/bias": ((c_out,), layers.zeros),
            f"{prefix}/kernel": ((k, c_in, c_out), layers.lecun_normal)}


class ConditionalUnet1D:
    def __init__(self, down_features: Tuple[int, ...] = (256, 512, 1024),
                 mid_layers: int = 2, kernel_size: int = 3,
                 n_groups: int = 8, time_features: int = 256):
        self.down_features = tuple(down_features)
        self.mid_layers = mid_layers
        self.kernel_size = kernel_size
        self.n_groups = n_groups
        self.time_features = time_features

    def _conv_norm_act(self, params, prefix, x):
        h = conv1d(x, params[f"{prefix}/Conv_0/kernel"],
                   params[f"{prefix}/Conv_0/bias"],
                   padding=self.kernel_size // 2)
        return mish(group_norm(h, params[f"{prefix}/GroupNorm_0/scale"],
                               params[f"{prefix}/GroupNorm_0/bias"],
                               self.n_groups))

    def _block(self, params, prefix, x, cond):
        """FiLMResBlock1D: conv-norm-mish, FiLM from mish(cond), again,
        plus the input (through a 1x1 conv where the widths differ)."""
        h = self._conv_norm_act(params, f"{prefix}/ConvNormAct1D_0", x)
        f = h.shape[-1]
        film = layers.dense(mish(cond), params[f"{prefix}/Dense_0/kernel"],
                            params[f"{prefix}/Dense_0/bias"])
        film = film.reshape(*cond.shape[:-1], 2, f)
        h = h * film[..., None, 0, :] + film[..., None, 1, :]
        h = self._conv_norm_act(params, f"{prefix}/ConvNormAct1D_1", h)
        skip = x
        if x.shape[-1] != f:
            skip = conv1d(x, params[f"{prefix}/Conv_0/kernel"],
                          params[f"{prefix}/Conv_0/bias"], padding=0)
        return h + skip

    def __call__(self, params, prefix: str, obs, action, time):
        """obs (B, w, d), action (B, w, horizon, a), time (B, w, 1) ->
        (B, w, horizon, down_features[0])."""
        t = fourier_time_embedding(time, self.time_features)
        t = layers.dense(t, params[f"{prefix}/time_mlp_0/kernel"],
                         params[f"{prefix}/time_mlp_0/bias"])
        t = layers.dense(mish(t), params[f"{prefix}/time_mlp_1/kernel"],
                         params[f"{prefix}/time_mlp_1/bias"])
        cond = torch.cat((obs, t), dim=-1)
        n_levels = len(self.down_features)
        skips, h = [], action
        for level in range(n_levels):
            for b in range(2):
                h = self._block(params, f"{prefix}/encoder_{level}_{b}", h,
                                cond)
            if level > 0:
                skips.append(h)
            if level < n_levels - 1:
                h = conv1d(h, params[f"{prefix}/downsamplers_{level}/kernel"],
                           params[f"{prefix}/downsamplers_{level}/bias"],
                           stride=2)
        for i in range(self.mid_layers):
            h = self._block(params, f"{prefix}/bottleneck_{i}", h, cond)
        for level in range(n_levels - 2, -1, -1):
            h = torch.cat((h, skips.pop()), dim=-1)
            for b in range(2):
                h = self._block(params, f"{prefix}/decoder_{level}_{b}", h,
                                cond)
            h = conv1d(h, params[f"{prefix}/upsamplers_{level}/kernel"],
                       params[f"{prefix}/upsamplers_{level}/bias"],
                       stride=2, transpose=True)
        return self._conv_norm_act(params, f"{prefix}/out_proj", h)

    def specs(self, prefix: str, action_dim: int, obs_dim: int
              ) -> Dict[str, Tuple[tuple, layers.Init]]:
        feats, k, tf = self.down_features, self.kernel_size, \
            self.time_features
        cond_dim = obs_dim + tf
        xavier = layers.xavier_uniform()
        specs = {
            f"{prefix}/time_mlp_0/bias": ((4 * tf,), layers.zeros),
            f"{prefix}/time_mlp_0/kernel": ((tf, 4 * tf), xavier),
            f"{prefix}/time_mlp_1/bias": ((tf,), layers.zeros),
            f"{prefix}/time_mlp_1/kernel": ((4 * tf, tf), xavier),
        }

        def block(name, c_in, f):
            p = f"{prefix}/{name}"
            for i, cin in enumerate((c_in, f)):
                specs.update(_conv_specs(f"{p}/ConvNormAct1D_{i}/Conv_0", k,
                                         cin, f))
                specs[f"{p}/ConvNormAct1D_{i}/GroupNorm_0/bias"] = (
                    (f,), layers.zeros)
                specs[f"{p}/ConvNormAct1D_{i}/GroupNorm_0/scale"] = (
                    (f,), layers.ones)
            specs[f"{p}/Dense_0/bias"] = ((2 * f,), layers.zeros)
            specs[f"{p}/Dense_0/kernel"] = ((cond_dim, 2 * f), xavier)
            if c_in != f:
                specs.update(_conv_specs(f"{p}/Conv_0", 1, c_in, f))

        c_in = action_dim
        for level, f in enumerate(feats):
            block(f"encoder_{level}_0", c_in, f)
            block(f"encoder_{level}_1", f, f)
            if level < len(feats) - 1:
                specs.update(_conv_specs(f"{prefix}/downsamplers_{level}", 3,
                                         f, f))
            c_in = f
        for i in range(self.mid_layers):
            block(f"bottleneck_{i}", feats[-1], feats[-1])
        for level in range(len(feats) - 2, -1, -1):
            block(f"decoder_{level}_0", 2 * feats[level + 1], feats[level])
            block(f"decoder_{level}_1", feats[level], feats[level])
            specs.update(_conv_specs(f"{prefix}/upsamplers_{level}", 4,
                                     feats[level], feats[level]))
        specs.update(_conv_specs(f"{prefix}/out_proj/Conv_0", k, feats[0],
                                 feats[0]))
        specs[f"{prefix}/out_proj/GroupNorm_0/bias"] = ((feats[0],),
                                                        layers.zeros)
        specs[f"{prefix}/out_proj/GroupNorm_0/scale"] = ((feats[0],),
                                                         layers.ones)
        return specs
