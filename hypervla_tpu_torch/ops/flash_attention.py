"""Forward online-softmax attention (counterpart of
hypervla_tpu/ops/flash_attention.py::flash_attention and ::mha_flash).

The Pallas TPU kernel `_flash_kernel` becomes a hand-written CUDA kernel
(csrc/flash_attention.cu): q, k, v widened to fp32, q scaled by 1/sqrt(d)
in fp32, scores, probabilities and both products in fp32, a streaming
softmax over key tiles, one rounding to q's type. For bf16 inputs both
products run on the bf16 tensor cores without changing that function: a
product of two bf16 values is exact in fp32, and the fp32 P is split into
three bf16 terms whose sum is P exactly (`split_bf16_terms`), one product
each into one fp32 accumulator. fp32 inputs stay on fp32 FMAs. No padding:
the key loop ends at the true length. `mha_flash` reads (batch, seq, heads, head_dim)
in place through strides, where the TPU wrapper transposes to
(batch*heads, seq, head_dim) and back.

Forward only, like the TPU kernel (it has no VJP): an input that requires a
gradient raises. `mha_flash_trainable` of the JAX package is not a kernel
of that package (on a TPU it calls jax's library kernel) and is not ported
(ROADMAP.md A13, the differentiable flash attention).

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
                                        i, f, i, i, i, i, p]
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
            "ported (ROADMAP.md A13, the differentiable flash attention)")


#: multiprocessors of the card the block size is chosen for (H100)
FLASH_SMS = 132


def flash_warps(batch_heads: int, q_len: int) -> int:
    """Warps (of 16 query rows) a block of the tensor-core kernel takes:
    four where the 64-row blocks still give every multiprocessor one, else
    two (the serving step's 12 heads x 257 rows: 108 blocks of 32 rows)."""
    return 4 if batch_heads * -(-q_len // 64) >= FLASH_SMS else 2


def split_bf16_terms(p):
    """fp32 p as the three bf16 terms (hi, mid, lo) the tensor-core kernel
    multiplies by V: hi = bf16(p), mid = bf16(p - hi), lo = bf16(p - hi -
    mid), each residual exact in fp32, so hi + mid + lo == p for every
    normal p (8 + 8 + 8 significand bits)."""
    hi = p.bfloat16()
    r = p - hi.float()
    mid = r.bfloat16()
    return hi, mid, (r - mid.float()).bfloat16()


def _launch(query, key, value, fma: bool):
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
    # 16-byte loads need every row of every operand on a 16-byte boundary
    vec = d % 8 == 0 and all(s % 8 == 0 for s in strides) and all(
        t.data_ptr() % 16 == 0 for t in (query, key, value))
    code = _lib().flash_attention_fwd(
        query.data_ptr(), key.data_ptr(), value.data_ptr(), out.data_ptr(),
        *strides, batch, heads, q_len, key.shape[1], d, 1.0 / math.sqrt(d),
        int(query.dtype == torch.float32), flash_warps(batch * heads, q_len),
        int(vec), int(fma), _stream())
    _raise_on_error("flash_attention_fwd", code)
    return out


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
    out = _launch(query, key, value, fma=False)
    LAUNCHES["flash_attention"] += 1
    return out


def mha_flash_fma(query, key, value):
    """The fp32-FMA kernel on bf16 CUDA inputs: the kernel `mha_flash`
    launched before its products moved to the tensor cores, kept as the
    yardstick its error is printed beside. On no model path; not counted."""
    _check(_route(query, key, value) == "cuda"
           and query.dtype == torch.bfloat16, "bf16 CUDA tensors only")
    return _launch(query, key, value, fma=True)


def flash_attention(q, k, v):
    """Unmasked self or cross attention. q (bh, q_len, d); k, v (bh,
    kv_len, d). Returns (bh, q_len, d) in q's type."""
    _check(q.dim() == 3 and k.dim() == 3 and v.dim() == 3,
           "q, k, v must be (batch*heads, seq, head_dim)")
    return mha_flash(q[:, :, None], k[:, :, None], v[:, :, None])[:, :, 0]
