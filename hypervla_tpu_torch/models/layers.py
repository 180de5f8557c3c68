"""Numerics and initializers shared by the port's modules.

The functions reproduce flax's: `layer_norm` is nn.LayerNorm (fp32 fast
variance, `(x - mu) * (rsqrt(var + eps) * scale) + bias`, never
F.layer_norm's two-pass variance), `dense` is nn.Dense with an (in, out)
kernel applied as `x @ W`. The initializers draw from an explicit
torch.Generator with the distributions flax uses for each param family
(the values differ from JAX's PRNG streams; the families match).
"""
import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

# an initializer: (shape, generator) -> fp32 tensor on the CPU
Init = Callable[[Sequence[int], torch.Generator], torch.Tensor]


def layer_norm(x, scale=None, bias=None, eps: float = 1e-6):
    """flax nn.LayerNorm over the last axis; statistics and result in fp32
    (the caller rounds to its compute dtype)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    mul = torch.rsqrt(var + eps)
    if scale is not None:
        mul = mul * scale.float()
    y = (xf - mu) * mul
    if bias is not None:
        y = y + bias.float()
    return y


def dense(x, kernel, bias=None):
    """flax Dense: x @ kernel (+ bias), kernel (in, out)."""
    y = x @ kernel
    return y if bias is None else y + bias


def gelu_tanh(x):
    """flax nn.gelu's default (tanh) approximation."""
    return F.gelu(x, approximate="tanh")


def gelu_exact(x):
    """jax.nn.gelu(approximate=False): 0.5 * x * erfc(-x / sqrt(2))."""
    return 0.5 * x * torch.erfc(-x * math.sqrt(0.5))


# ------------------------------ initializers ------------------------------


def _fans(shape):
    """jax.nn.initializers' fans: in axis -2, out axis -1, the rest the
    receptive field."""
    if len(shape) < 2:
        return shape[0] if shape else 1, shape[0] if shape else 1
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def _truncated(shape, std, gen):
    """Normal(0, std) truncated to +-2 std."""
    t = torch.empty(tuple(shape))
    return torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                       generator=gen) * std


def zeros(shape, gen=None):
    return torch.zeros(tuple(shape))


def ones(shape, gen=None):
    return torch.ones(tuple(shape))


def normal(std: float) -> Init:
    return lambda shape, gen: torch.randn(tuple(shape), generator=gen) * std


def truncated_normal(std: float) -> Init:
    return lambda shape, gen: _truncated(shape, std, gen)


def variance_scaling(scale: float) -> Init:
    """variance_scaling(scale, "fan_in", "truncated_normal")."""
    def init(shape, gen):
        # 0.879... is the std of a unit normal truncated to +-2
        std = math.sqrt(scale / _fans(shape)[0]) / 0.87962566103423978
        return _truncated(shape, std, gen)
    return init


lecun_normal = variance_scaling(1.0)


def xavier_uniform(flat_shape=None) -> Init:
    """xavier_uniform over `flat_shape` (DenseGeneral flattens its kernel
    to 2-D for the fans), reshaped to the param's shape."""
    def init(shape, gen):
        fan_in, fan_out = _fans(flat_shape or shape)
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        u = torch.rand(tuple(shape), generator=gen)
        return (2.0 * u - 1.0) * limit
    return init


def init_params(specs, seed: int, device=None):
    """{name: (shape, init)} -> fp32 params on `device`, drawn in the
    specs' order from one generator seeded with `seed`."""
    gen = torch.Generator().manual_seed(seed)
    return {name: init(shape, gen).float().to(device)
            for name, (shape, init) in specs.items()}


# ------------------------------ convolutions ------------------------------


def _per_channel(v, channels: int):
    """A bias or scale of `channels` entries, shared (C,) or per sample
    ((B, C), or (B, 1, C) from models/hypernetwork.py::per_sample_view) ->
    (1 or B, C, 1, 1), to broadcast over NCHW activations."""
    return v.reshape(-1, channels)[:, :, None, None]


def conv2d(x, kernel, bias=None, stride: int = 1, padding: int = 0,
           groups: int = 1):
    """flax's NHWC convolution on NCHW activations: x (B, C, H, W); kernel
    in the JAX HWIO layout, (kh, kw, in / groups, out) shared by the batch
    or (B, kh, kw, in / groups, out) per sample, as the hypernetwork
    generates it (the counterpart of the JAX train step's vmap over
    generated params: one grouped convolution with `groups` groups a
    sample). padding p is [(p, p), (p, p)]; 0 is "VALID"."""
    if kernel.dim() == 4:
        y = F.conv2d(x, kernel.permute(3, 2, 0, 1), stride=stride,
                     padding=padding, groups=groups)
    else:
        batch, _, _, c_in, c_out = kernel.shape
        if x.shape[0] != batch:
            raise ValueError(f"{batch} per-sample kernels for a batch of "
                             f"{x.shape[0]}")
        w = kernel.permute(0, 4, 3, 1, 2).reshape(batch * c_out, c_in,
                                                  *kernel.shape[1:3])
        y = F.conv2d(x.reshape(1, batch * x.shape[1], *x.shape[2:]), w,
                     stride=stride, padding=padding, groups=batch * groups)
        y = y.reshape(batch, c_out, *y.shape[2:])
    if bias is not None:
        y = y + _per_channel(bias, y.shape[1])
    return y


def same_padding(size: int, kernel: int, stride: int):
    """XLA's "SAME" padding of one spatial axis: (low, high), the low side
    total // 2 (so at stride 2 the odd pixel goes on the high side)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pad_same(x, kh: int, kw: int, stride: int, value: float = 0.0):
    """NCHW x padded as XLA's "SAME" pads for a (kh, kw) window."""
    ph = same_padding(x.shape[2], kh, stride)
    pw = same_padding(x.shape[3], kw, stride)
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)


def standardize_kernel(kernel, eps: float = 1e-5):
    """StdConv's weight standardization of an HWIO kernel, each sample's
    own for a per-sample (B, kh, kw, in, out) one: re-centred and divided
    by the population std over (h, w, in) plus eps."""
    dims = (-4, -3, -2)
    kernel = kernel - kernel.mean(dims, keepdim=True)
    return kernel / (kernel.std(dims, correction=0, keepdim=True) + eps)


def group_norm(x, scale, bias, num_groups: int = 32, eps: float = 1e-6):
    """flax nn.GroupNorm over NCHW activations: statistics per sample and
    group over (h, w, channels of the group) in fp32 with the fast variance
    E[x^2] - E[x]^2 (clipped at 0), then (x - mu) * (rsqrt(var + eps) *
    scale) + bias. scale and bias are (C,) or per sample, or None (flax's
    use_scale / use_bias False)."""
    b, c, h, w = x.shape
    g = x.float().reshape(b, num_groups, c // num_groups, h, w)
    mu = g.mean((2, 3, 4), keepdim=True)
    var = torch.clamp((g * g).mean((2, 3, 4), keepdim=True) - mu * mu,
                      min=0.0)
    mul = torch.rsqrt(var + eps).expand(b, num_groups, c // num_groups, 1, 1)
    mul = mul.reshape(b, c, 1, 1)
    if scale is not None:
        mul = mul * _per_channel(scale, c)
    y = (x.float() - mu.repeat_interleave(c // num_groups, 1).reshape(
        b, c, 1, 1)) * mul
    return y if bias is None else y + _per_channel(bias, c)
