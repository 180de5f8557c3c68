"""Fused multi-head attention for the bf16 training trunk, forward and
backward (counterpart of hypervla_tpu/ops/fused_attention.py).

The Pallas TPU kernel `mha_fused_train` becomes two hand-written CUDA entry
points (csrc/fused_attention.cu): `mha_fused_train_fwd` -> (o, P) and
`mha_fused_train_bwd` -> (dq, dk, dv), joined by a torch.autograd.Function
whose saved residual is the bf16 probabilities P. q, k, v and o keep the
(B, S, H*D) layout the Dense layers emit. On the card P is the `[..., :S]`
view of a (B, H, S, SP) buffer whose row stride SP is S rounded up to 8
values (`probs_row_stride`), so that every row starts 16-byte aligned for
the kernels' vector accesses; its pad columns hold zeros. Beside each
kernel is its plain PyTorch version with the same rounding points (the TPU
kernels' bodies): bf16 scaled q, scores from an fp32 sum rounded to bf16,
fp32 softmax stored as bf16 P, P.v from an fp32 sum rounded to bf16; the
backward rounds dv, ds, dq and dk to bf16 where the TPU kernel does.

A wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches its kernel or raises. Each launch adds one to
`LAUNCHES[<name>]`.
"""
import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from hypervla_tpu_torch.ops.dino_layer import (
    _check,
    _raise_on_error,
    _route,
    _stream,
)

HEAD_DIM = 64

#: launches of each CUDA entry point since the last reset
LAUNCHES: Dict[str, int] = {"mha_fused_train_fwd": 0,
                            "mha_fused_train_bwd": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _lib():
    """The built kernel library, its C signatures declared (built and
    loaded at the first launch, never at import)."""
    from hypervla_tpu_torch.utils.cuda_build import load_library

    lib = load_library("fused_attention.cu")
    p, i, f, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_long
    lib.mha_fused_train_fwd.argtypes = [p, p, p, n, p, p, i, i, i, f, p]
    lib.mha_fused_train_bwd.argtypes = [p, p, p, n, p, p, p, p, p, n, p, i,
                                        i, i, f, p]
    lib.mha_max_seq.argtypes = []
    for fn in (lib.mha_fused_train_fwd, lib.mha_fused_train_bwd,
               lib.mha_max_seq):
        fn.restype = ctypes.c_int
    return lib


def _bf16_scale(scale: float) -> float:
    """The scale as the kernels apply it to q: rounded to bf16."""
    return float(torch.tensor(scale, dtype=torch.bfloat16))


def _heads(t, heads: int):
    """(B, S, H*D) -> fp32 (B, H, S, D)."""
    b, s, hd = t.shape
    return t.reshape(b, s, heads, hd // heads).transpose(1, 2).float()


def _merge(t):
    """(B, H, S, D) -> (B, S, H*D)."""
    b, h, s, d = t.shape
    return t.transpose(1, 2).reshape(b, s, h * d)


# ------------------------------- forward -------------------------------


def mha_fused_train_fwd_reference(q, k, v, heads: int, scale: float):
    """Plain PyTorch forward: (o (B, S, H*D) bf16, P (B, H, S, S) bf16)."""
    q2 = (q.float() * _bf16_scale(scale)).bfloat16()
    scores = (_heads(q2, heads) @ _heads(k, heads).transpose(-1, -2))
    scores = scores.bfloat16().float()
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    probs = (e / e.sum(-1, keepdim=True)).bfloat16()
    o = (probs.float() @ _heads(v, heads)).bfloat16()
    return _merge(o), probs


def _check_qkv(q, k, v, heads: int):
    _check(q.dim() == 3 and q.dtype == torch.bfloat16,
           f"q must be (B, S, H*D) bf16, got {q.dtype} {tuple(q.shape)}")
    _check(q.shape == k.shape == v.shape, "q, k, v shapes differ")
    _check(q.shape[2] == heads * HEAD_DIM,
           f"width {q.shape[2]} is not {heads} heads x {HEAD_DIM}")
    _check(k.dtype == v.dtype == torch.bfloat16, "k, v must be bf16")
    _check(q.shape[1] <= _lib().mha_max_seq(),
           f"sequence {q.shape[1]} exceeds the {_lib().mha_max_seq()} rows "
           "the kernels' shared memory holds")


def _row_stride(q, k, v) -> int:
    """The row stride q, k, v share. They may be column slices of one
    (B, S, 3*H*D) buffer: equal strides, unit inner stride and a dense
    batch stride; rows 16-byte aligned for the kernels' 16-byte copies."""
    s, ld = q.shape[1], q.stride(1)
    for t in (q, k, v):
        _check(t.stride() == (s * ld, ld, 1) and ld % 8 == 0
               and t.data_ptr() % 16 == 0,
               "q, k, v need strides (S*ld, ld, 1), ld % 8 == 0 and "
               "16-byte alignment")
    return ld


def probs_row_stride(seq: int) -> int:
    """The row stride, in values, of P and of the backward's ds scratch on
    the card: seq rounded up to a multiple of 8."""
    return -(-seq // 8) * 8


def _empty_probs(b: int, heads: int, s: int, device) -> torch.Tensor:
    """The (B, H, S, S) view of a new (B, H, S, SP) bf16 buffer."""
    return torch.empty((b, heads, s, probs_row_stride(s)),
                       dtype=torch.bfloat16, device=device)[..., :s]


def _is_padded_probs(probs) -> bool:
    _, heads, s, _ = probs.shape
    sp = probs_row_stride(s)
    return (probs.stride() == (heads * s * sp, s * sp, sp, 1)
            and probs.data_ptr() % 16 == 0)


def padded_probs(probs) -> torch.Tensor:
    """P in the layout the backward kernels read: the tensor itself if it
    already is a `[..., :S]` view of a (B, H, S, SP) buffer (as the forward
    returns it), else a copy into one, the pad columns zero."""
    if _is_padded_probs(probs):
        return probs
    b, heads, s, _ = probs.shape
    out = torch.zeros((b, heads, s, probs_row_stride(s)), dtype=probs.dtype,
                      device=probs.device)
    out[..., :s] = probs
    return out[..., :s]


def _launch_fwd(q, k, v, heads: int, scale: float, store_p: bool):
    """Launches the forward kernel (no launch counted)."""
    _check_qkv(q, k, v, heads)
    b, s, hd = q.shape
    ld = _row_stride(q, k, v)
    o = torch.empty((b, s, hd), dtype=torch.bfloat16, device=q.device)
    probs = _empty_probs(b, heads, s, q.device) if store_p else None
    code = _lib().mha_fused_train_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ld, o.data_ptr(),
        probs.data_ptr() if store_p else None, b, s, heads, float(scale),
        _stream(),
    )
    _raise_on_error("mha_fused_train_fwd", code)
    return o, probs


def mha_fused_train_fwd(q, k, v, heads: int, scale: float,
                        store_p: bool = True
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """o = softmax(q k^T * scale) v per head, and the bf16 probabilities P
    (None without store_p)."""
    if _route(q, k, v) == "cpu":
        o, probs = mha_fused_train_fwd_reference(q, k, v, heads, scale)
        return o, (probs if store_p else None)
    out = _launch_fwd(q, k, v, heads, scale, store_p)
    LAUNCHES["mha_fused_train_fwd"] += 1
    return out


# ------------------------------- backward -------------------------------


def mha_fused_train_bwd_reference(q, k, v, probs, g, heads: int,
                                  scale: float):
    """Plain PyTorch backward from the saved bf16 P: (dq, dk, dv) bf16."""
    pf = probs.float()
    gh, vh = _heads(g, heads), _heads(v, heads)
    q2 = _heads((q.float() * _bf16_scale(scale)).bfloat16(), heads)
    dv = (pf.transpose(-1, -2) @ gh).bfloat16()
    dpp = (gh @ vh.transpose(-1, -2)) * pf
    ds = (dpp - pf * dpp.sum(-1, keepdim=True)).bfloat16().float()
    dq = ((ds @ _heads(k, heads)) * scale).bfloat16()
    dk = (ds.transpose(-1, -2) @ q2).bfloat16()
    return _merge(dq), _merge(dk), _merge(dv)


def _launch_bwd(q, k, v, probs, g, heads: int, scale: float):
    """Launches the backward kernels (no launch counted). q, k, v as the
    forward takes them; P as the forward returns it (any other layout is
    first copied into that one); returns one (B, S, 3*H*D) buffer
    [dq | dk | dv]."""
    _check_qkv(q, k, v, heads)
    b, s, hd = q.shape
    ld = _row_stride(q, k, v)
    _check(g.is_contiguous() and g.shape == (b, s, hd)
           and g.dtype == torch.bfloat16,
           "g must be contiguous (B, S, H*D) bf16")
    _check(probs.dtype == torch.bfloat16
           and probs.shape == (b, heads, s, s), "P must be (B, H, S, S) bf16")
    probs = padded_probs(probs)
    dqkv = torch.empty((b, s, 3 * hd), dtype=torch.bfloat16, device=q.device)
    dq, dk, dv = dqkv[..., :hd], dqkv[..., hd:2 * hd], dqkv[..., 2 * hd:]
    ds = _empty_probs(b, heads, s, q.device)
    code = _lib().mha_fused_train_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ld, probs.data_ptr(),
        g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), 3 * hd,
        ds.data_ptr(), b, s, heads, float(scale), _stream(),
    )
    _raise_on_error("mha_fused_train_bwd", code)
    return dqkv


def mha_fused_train_bwd(q, k, v, probs, g, heads: int, scale: float):
    if _route(q, k, v, probs, g) == "cpu":
        return mha_fused_train_bwd_reference(q, k, v, probs, g, heads,
                                             scale)
    dqkv = _launch_bwd(q, k, v, probs, g, heads, scale)
    LAUNCHES["mha_fused_train_bwd"] += 1
    hd = q.shape[2]
    return dqkv[..., :hd], dqkv[..., hd:2 * hd], dqkv[..., 2 * hd:]


# ------------------------------- autograd -------------------------------


class _MhaFusedTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, heads, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, probs = mha_fused_train_fwd(q, k, v, heads, scale)
        ctx.save_for_backward(q, k, v, probs)
        ctx.heads, ctx.scale = heads, scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, probs = ctx.saved_tensors
        dq, dk, dv = mha_fused_train_bwd(q, k, v, probs, g.contiguous(),
                                         ctx.heads, ctx.scale)
        return dq, dk, dv, None, None


def mha_fused_train(q, k, v, heads: int, scale: float):
    """Differentiable fused MHA over (B, S, H*D) bf16 q, k, v; returns
    (B, S, H*D) bf16. The bf16 probabilities are the saved residual."""
    return _MhaFusedTrain.apply(q, k, v, heads, scale)
