"""Forward online-softmax attention (counterpart of
hypervla_tpu/ops/flash_attention.py::flash_attention and ::mha_flash).

The Pallas TPU kernel `_flash_kernel` becomes a hand-written CUDA kernel
(csrc/flash_attention.cu): q, k, v widened to fp32, q scaled by 1/sqrt(d)
in fp32, scores, probabilities and both products in fp32, a streaming
softmax over key tiles, one rounding to q's type. No padding: the key loop
ends at the true length. `mha_flash` reads (batch, seq, heads, head_dim)
in place through strides, where the TPU wrapper transposes to
(batch*heads, seq, head_dim) and back.

Forward only, like the TPU kernel (it has no VJP): an input that requires a
gradient raises. `mha_flash_trainable` of the JAX package is not a kernel
of that package (on a TPU it calls jax's library kernel) and is not ported
(ROADMAP.md, queue A).

Beside the kernel is its plain PyTorch version. A wrapper takes it only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises. Each
launch adds one to `LAUNCHES["flash_attention"]`.
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

#: launches of the kernel since the last reset
LAUNCHES: Dict[str, int] = {"flash_attention": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _lib():
    """The built kernel library, its C signatures declared (built and
    loaded at the first launch, never at import)."""
    from hypervla_tpu_torch.utils.cuda_build import load_library

    lib = load_library("flash_attention.cu")
    p, i, f, n = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_longlong)
    lib.flash_attention_max_head_dim.argtypes = []
    lib.flash_attention_fwd.argtypes = [p, p, p, p, *([n] * 12), i, i, i, i,
                                        i, f, i, p]
    lib.flash_attention_max_head_dim.restype = ctypes.c_int
    lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def mha_flash_reference(query, key, value):
    """Plain PyTorch version over (batch, seq, heads, head_dim): the full
    fp32 softmax of (q * scale) k^T, times v in fp32, one rounding to q's
    type."""
    scale = 1.0 / math.sqrt(query.shape[-1])
    q = query.float().transpose(1, 2) * scale
    k, v = key.float().transpose(1, 2), value.float().transpose(1, 2)
    probs = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
    return (probs @ v).transpose(1, 2).to(query.dtype)


def flash_attention_reference(q, k, v):
    """Plain PyTorch version over (batch*heads, seq, head_dim)."""
    return mha_flash_reference(q[:, :, None], k[:, :, None],
                               v[:, :, None])[:, :, 0]


def _forward_only(*tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "flash_attention is forward only (the TPU kernel has no VJP): "
            "run it under torch.no_grad(); the differentiable twin is not "
            "ported (ROADMAP.md, queue A)")


def mha_flash(query, key, value):
    """Unmasked multi-head attention. query (batch, q_len, heads, d); key,
    value (batch, kv_len, heads, d); all bf16 or all fp32, the head dim
    contiguous. Returns (batch, q_len, heads, d) in query's type."""
    _forward_only(query, key, value)
    _check(query.dim() == 4 and key.shape == value.shape
           and key.shape[0] == query.shape[0]
           and key.shape[2:] == query.shape[2:] and key.shape[1] >= 1,
           f"shapes: query {tuple(query.shape)}, key {tuple(key.shape)}, "
           f"value {tuple(value.shape)}")
    _check(query.dtype == key.dtype == value.dtype,
           "query, key, value must have one type")
    if _route(query, key, value) == "cpu":
        return mha_flash_reference(query, key, value)
    batch, q_len, heads, d = query.shape
    _check(query.dtype in (torch.bfloat16, torch.float32),
           f"query must be bf16 or fp32, got {query.dtype}")
    _check(d <= _lib().flash_attention_max_head_dim(),
           f"head dim {d} exceeds the kernel's registers")
    _check(batch * heads <= 65535, "batch * heads exceeds the grid")
    query, key, value = (t if t.stride(-1) == 1 else t.contiguous()
                         for t in (query, key, value))
    out = torch.empty((batch, q_len, heads, d), dtype=query.dtype,
                      device=query.device)
    strides = [s for t in (query, key, value, out)
               for s in (t.stride(0), t.stride(2), t.stride(1))]
    code = _lib().flash_attention_fwd(
        query.data_ptr(), key.data_ptr(), value.data_ptr(), out.data_ptr(),
        *strides, batch, heads, q_len, key.shape[1], d, 1.0 / math.sqrt(d),
        int(query.dtype == torch.float32), _stream())
    _raise_on_error("flash_attention_fwd", code)
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention(q, k, v):
    """Unmasked self or cross attention. q (bh, q_len, d); k, v (bh,
    kv_len, d). Returns (bh, q_len, d) in q's type."""
    _check(q.dim() == 3 and k.dim() == 3 and v.dim() == 3,
           "q, k, v must be (batch*heads, seq, head_dim)")
    return mha_flash(q[:, :, None], k[:, :, None], v[:, :, None])[:, :, 0]
