"""Differentiable multi-head attention whose probabilities never reach
device memory (counterpart of hypervla_tpu/ops/flash_attention.py::
mha_flash_trainable).

The JAX function is no Pallas kernel of that package: on a TPU it calls
jax's library flash attention, whose VJP recomputes the probabilities, and
elsewhere it runs an einsum attention. The port computes that einsum
function and its VJP, with their rounding points, in two hand-written CUDA
entry points (csrc/flash_attention_train.cu): `mha_flash_trainable_fwd` ->
(o, the row max m, the row sum n) and `mha_flash_trainable_bwd` -> (dq,
dk, dv), joined by a torch.autograd.Function whose saved residuals are q,
k, v, m and n. For T the inputs' type (bf16 or fp32):

    qs = fp32(q) * scale, scale = fp32(1 / sqrt(d))
    s = qs . fp32(k)^T (fp32); e = exp(s - max s); n = sum e
    p = T(e / n); o = T(p . v) with an fp32 sum
    dv = T(p^T . g); dp = fp32(T(g . v^T))
    r = sum_k (dp * (1 / (n * n))) * e; ds = (dp / n - r) * e (fp32)
    dq = T(fp32(ds . k) * scale); dk = T(ds^T . qs)

Beside each kernel is its plain PyTorch version with the same rounding
points. A wrapper takes it only for tensors on the CPU; for CUDA tensors it
launches its kernel or raises. Each launch adds one to
`LAUNCHES[<name>]`. The function runs under torch.no_grad() as well (the
JAX serving path with `flash_attention_trainable` calls it there).
"""
import ctypes
import functools
import math
from typing import Dict

import torch

from hypervla_tpu_torch.ops.dino_layer import (
    _check,
    _raise_on_error,
    _route,
    _stream,
)

#: launches of each CUDA entry point since the last reset
LAUNCHES: Dict[str, int] = {"mha_flash_trainable_fwd": 0,
                            "mha_flash_trainable_bwd": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _lib():
    """The built kernel library, its C signatures declared (built and
    loaded at the first launch, never at import)."""
    from hypervla_tpu_torch.utils.cuda_build import load_library

    lib = load_library("flash_attention_train.cu")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_trainable_max_head_dim.argtypes = []
    lib.mha_flash_trainable_fwd.argtypes = [p] * 6 + [i] * 3 + [i, f, i, i,
                                                                i, p]
    lib.mha_flash_trainable_bwd.argtypes = [p] * 10 + [i] * 4 + [f, i, i, i,
                                                                 p]
    for fn in (lib.flash_trainable_max_head_dim,
               lib.mha_flash_trainable_fwd, lib.mha_flash_trainable_bwd):
        fn.restype = ctypes.c_int
    return lib


def softmax_scale(head_dim: int) -> float:
    """1 / sqrt(head_dim) as the JAX function applies it: a float64
    rounded to fp32 where it multiplies fp32(q)."""
    return float(torch.tensor(1.0 / math.sqrt(head_dim),
                              dtype=torch.float32))


def q_terms(scale: float) -> int:
    """The bf16 terms the tensor-core kernels split fp32(q) * scale into:
    one where the scale is a power of two (then it is a bf16 value), else
    three, whose sum is it exactly."""
    return 1 if math.frexp(scale)[0] == 0.5 else 3


def _heads(t):
    """(B, S, H, D) -> fp32 (B, H, S, D)."""
    return t.float().transpose(1, 2)


def _out(t, dtype):
    """fp32 (B, H, S, D) -> (B, S, H, D) in dtype, contiguous."""
    return t.to(dtype).transpose(1, 2).contiguous()


# ------------------------------- forward -------------------------------


def mha_flash_trainable_fwd_reference(query, key, value):
    """Plain PyTorch forward: (o (B, S, H, D) in q's type, m, n (B, H, S)
    fp32)."""
    qs = _heads(query) * softmax_scale(query.shape[-1])
    s = qs @ _heads(key).transpose(-1, -2)
    m = s.amax(-1)
    e = torch.exp(s - m[..., None])
    n = e.sum(-1)
    p = (e / n[..., None]).to(query.dtype)
    return _out(p.float() @ _heads(value), query.dtype), m, n


def _check_qkv(query, key, value):
    _check(query.dim() == 4 and query.shape == key.shape == value.shape,
           f"query, key, value must be one (batch, seq, heads, head_dim) "
           f"shape: {tuple(query.shape)}, {tuple(key.shape)}, "
           f"{tuple(value.shape)}")
    _check(query.dtype in (torch.bfloat16, torch.float32)
           and query.dtype == key.dtype == value.dtype,
           f"query, key, value must all be bf16 or all fp32: {query.dtype}, "
           f"{key.dtype}, {value.dtype}")
    _check(query.shape[1] >= 1, "the sequence is empty")


def _launch_args(query):
    batch, seq, heads, d = query.shape
    widest = _lib().flash_trainable_max_head_dim()
    _check(d <= widest, f"head dim {d} exceeds the kernels' {widest}")
    _check(batch * heads <= 65535, "batch * heads exceeds the grid")
    scale = softmax_scale(d)
    return batch, heads, seq, d, scale, int(query.dtype == torch.float32), \
        q_terms(scale)


def _vec(d, *tensors) -> int:
    """16-byte loads: the head dim a multiple of 8 values and every operand
    16-byte aligned (contiguous rows are then 16-byte aligned too)."""
    return int(d % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def _launch_fwd(query, key, value):
    """Launches the forward kernel (no launch counted)."""
    query, key, value = (t.contiguous() for t in (query, key, value))
    batch, heads, seq, d, scale, is_f32, nt = _launch_args(query)
    o = torch.empty_like(query)
    m = torch.empty((batch, heads, seq), dtype=torch.float32,
                    device=query.device)
    n = torch.empty_like(m)
    code = _lib().mha_flash_trainable_fwd(
        query.data_ptr(), key.data_ptr(), value.data_ptr(), o.data_ptr(),
        m.data_ptr(), n.data_ptr(), batch, heads, seq, d, scale, is_f32, nt,
        _vec(d, query, key, value, o), _stream())
    _raise_on_error("mha_flash_trainable_fwd", code)
    return o, m, n


def mha_flash_trainable_fwd(query, key, value):
    """(o, m, n): o = softmax(qs k^T) v per head, (batch, seq, heads, d) in
    the inputs' type; m, n the fp32 row max and row sum, (batch, heads,
    seq), the backward's residuals."""
    _check_qkv(query, key, value)
    if _route(query, key, value) == "cpu":
        return mha_flash_trainable_fwd_reference(query, key, value)
    out = _launch_fwd(query, key, value)
    LAUNCHES["mha_flash_trainable_fwd"] += 1
    return out


# ------------------------------- backward -------------------------------


def mha_flash_trainable_bwd_reference(query, key, value, g, m, n):
    """Plain PyTorch backward from the row stats: (dq, dk, dv) in q's
    type, (batch, seq, heads, d)."""
    dtype = query.dtype
    scale = softmax_scale(query.shape[-1])
    qs = _heads(query) * scale
    kf, vf, gf = _heads(key), _heads(value), _heads(g)
    n = n[..., None]
    e = torch.exp(qs @ kf.transpose(-1, -2) - m[..., None])
    p = (e / n).to(dtype).float()
    dv = p.transpose(-1, -2) @ gf
    dp = (gf @ vf.transpose(-1, -2)).to(dtype).float()
    r = (dp * (1 / (n * n)) * e).sum(-1, keepdim=True)
    ds = (dp / n - r) * e
    return (_out((ds @ kf) * scale, dtype),
            _out(ds.transpose(-1, -2) @ qs, dtype), _out(dv, dtype))


def _launch_bwd(query, key, value, g, m, n):
    """Launches the backward kernels, dq's then dk/dv's (no launch
    counted)."""
    query, key, value, g = (t.contiguous()
                            for t in (query, key, value, g))
    batch, heads, seq, d, scale, is_f32, nt = _launch_args(query)
    _check(g.shape == query.shape and g.dtype == query.dtype,
           f"g must be {tuple(query.shape)} {query.dtype}")
    for t in (m, n):
        _check(t.shape == (batch, heads, seq) and t.dtype == torch.float32
               and t.is_contiguous(), "m, n must be contiguous (batch, "
               "heads, seq) fp32")
    dq, dk, dv = (torch.empty_like(query) for _ in range(3))
    r = torch.empty_like(m)
    code = _lib().mha_flash_trainable_bwd(
        query.data_ptr(), key.data_ptr(), value.data_ptr(), g.data_ptr(),
        m.data_ptr(), n.data_ptr(), r.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), batch, heads, seq, d, scale, is_f32,
        nt, _vec(d, query, key, value, g, dq, dk, dv), _stream())
    _raise_on_error("mha_flash_trainable_bwd", code)
    return dq, dk, dv


def mha_flash_trainable_bwd(query, key, value, g, m, n):
    """(dq, dk, dv) of the forward at (query, key, value) for the output's
    gradient g, from the forward's row stats m, n."""
    _check_qkv(query, key, value)
    if _route(query, key, value, g, m, n) == "cpu":
        return mha_flash_trainable_bwd_reference(query, key, value, g, m, n)
    out = _launch_bwd(query, key, value, g, m, n)
    LAUNCHES["mha_flash_trainable_bwd"] += 1
    return out


# ------------------------------- autograd -------------------------------


class _MhaFlashTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, query, key, value, plain):
        fwd = mha_flash_trainable_fwd_reference if plain else \
            mha_flash_trainable_fwd
        o, m, n = fwd(query, key, value)
        ctx.save_for_backward(query, key, value, m, n)
        ctx.plain = plain
        return o

    @staticmethod
    def backward(ctx, g):
        bwd = mha_flash_trainable_bwd_reference if ctx.plain else \
            mha_flash_trainable_bwd
        q, k, v, m, n = ctx.saved_tensors
        return (*bwd(q, k, v, g, m, n), None)


def mha_flash_trainable(query, key, value):
    """Differentiable multi-head attention over (batch, seq, heads,
    head_dim) query, key, value, all bf16 or all fp32; returns (batch, seq,
    heads, head_dim) in their type. The probabilities are recomputed in
    the backward from the row stats, never stored."""
    return _MhaFlashTrainable.apply(query, key, value, False)


def mha_flash_trainable_reference(query, key, value):
    """`mha_flash_trainable` over the plain versions whatever the device:
    the yardstick the kernels are held against."""
    _check_qkv(query, key, value)
    return _MhaFlashTrainable.apply(query, key, value, True)
