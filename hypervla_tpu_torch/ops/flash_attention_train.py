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

How the kernels launch is decided here, from the shape alone, and handed
to the C entry points: `flash_train_plan` (rows of a block, each kernel's
shared memory, the grids, the route), which the CPU tests hold. bf16
inputs multiply on the bf16 tensor cores; fp32 inputs too, each fp32
operand split into three bf16 terms hi = bf16(x), mid = bf16(x - hi), lo
= bf16(x - hi - mid) and each product the fp32 sum of the six term
products a_i . b_j with i + j <= 2: the "fp32_split" route, which every
fp32 shape takes.
"""
import ctypes
import functools
import math
from typing import Dict, NamedTuple, Tuple

import torch

from hypervla_tpu_torch.ops.dino_layer import (
    SMS,
    _check,
    _raise_on_error,
    _route,
    _stream,
)

#: launches of each CUDA entry point since the last reset
LAUNCHES: Dict[str, int] = {"mha_flash_trainable_fwd": 0,
                            "mha_flash_trainable_bwd": 0}
#: of those, the launches on fp32 tensors (the plan's "fp32_split" route)
FP32_LAUNCHES: Dict[str, int] = dict.fromkeys(LAUNCHES, 0)


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, FP32_LAUNCHES):
        for name in counts:
            counts[name] = 0


@functools.cache
def _lib():
    """The built kernel library, its C signatures declared (built and
    loaded at the first launch, never at import)."""
    from hypervla_tpu_torch.utils.cuda_build import load_library

    return declare(load_library("flash_attention_train.cu"))


def declare(lib):
    """Declares the C signatures of a library built from
    csrc/flash_attention_train.cu; returns it."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_trainable_max_head_dim.argtypes = []
    lib.mha_flash_trainable_fwd.argtypes = [p] * 7 + [i] * 4 + [f] + \
        [i] * 5 + [p]
    lib.mha_flash_trainable_bwd.argtypes = [p] * 11 + [i] * 4 + [f] + \
        [i] * 6 + [p]
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
    """The bf16 terms the bf16 kernels split fp32(q) * scale into: one
    where the scale is a power of two (then it is a bf16 value), else
    three, whose sum is it exactly. The fp32 kernels always take three."""
    return 1 if math.frexp(scale)[0] == 0.5 else 3


#: rows of a full block (one warpgroup's `wgmma` tile, four warps of 16)
#: and keys (the dk/dv kernel: queries) of a ring stage
TILE = 64
#: the load ring: stages of K/V (dk/dv: q terms, g and row terms) tiles,
#: the source's STAGES
RING_STAGES = 2


class FlashTrainPlan(NamedTuple):
    """How the kernels of one (batch * heads, seq, head_dim, dtype) launch:
    `flash_train_plan`."""
    rows: int  # rows of a block: queries (forward, dq), keys (dk/dv)
    key_tile: int  # keys (dk/dv: queries) of a ring stage
    smem_fwd: int  # dynamic shared memory of each kernel, bytes
    smem_dq: int
    smem_dkdv: int
    grid: Tuple[int, int]  # (blocks a head, batch * heads), every kernel's
    q_terms: int  # bf16 terms of fp32(q) * scale in the products
    route: str  # "bf16", or "fp32_split": every operand as three terms
    padded_dim: int  # the head dim's columns in a shared-memory tile
    live_work: int  # seq * seq, the scores of one head
    score_work: int  # scores a head's forward sweep forms (exponentials)
    product_work: int  # (row, key) pairs its products multiply


def _up(x: int, to: int) -> int:
    return -(-x // to) * to


def _rows_for(seq: int, batch_heads: int, sms: int) -> int:
    """Rows a block takes: 64 (a `wgmma` warpgroup) where those blocks give
    every multiprocessor one, else 32, else 16 (one warp's rows on
    `mma.sync`), so that a small batch, such as serving's one image of 12
    heads, still spreads over the card."""
    for rows in (TILE, 32):
        if -(-seq // rows) * batch_heads >= sms:
            return rows
    return 16


@functools.cache
def flash_train_plan(batch_heads: int, seq: int, head_dim: int,
                     dtype: torch.dtype, sms: int = SMS) -> FlashTrainPlan:
    """The launch plan of the forward and backward kernels
    (csrc/flash_attention_train.cu), from the shape alone.

    bf16: the head dim is padded to 64 or 128 (`padded_dim` columns of a
    shared-memory tile, 128-byte swizzled rows of 64 values), and the
    ring holds RING_STAGES stages of tiles. A block holds 64 rows, or 32
    or 16 where the grid would leave multiprocessors idle; a block whose
    live rows fill all four warps multiplies on `wgmma`, else each warp
    with live rows on `mma.sync`. Rows are taken in 16s and keys in 8s (a
    key tile's last `wgmma` is 16, 32, 48 or 64 keys wide; its
    exponentials skip the 8-key groups past the sequence): `score_work`
    counts a head's scores so formed per sweep, `product_work` the (row,
    key) pairs of its products, both against `live_work`. fp32, route
    "fp32_split" at every head dim: the same tiles, every operand's tile
    as its three bf16 terms (`fp32_smem`), in 64-row blocks that all take
    `wgmma` on whole 64-row, 64-key tiles (its exponentials skip the 8-key
    groups past the sequence)."""
    _check(dtype in (torch.bfloat16, torch.float32),
           f"the kernels take bf16 or fp32, not {dtype}")
    _check(seq >= 1 and 1 <= head_dim <= 128 and batch_heads >= 1,
           f"no plan for {batch_heads} x {seq} x {head_dim}")
    f32 = dtype == torch.float32
    nt = 3 if f32 else q_terms(softmax_scale(head_dim))
    dn = 64 if head_dim <= 64 else 128
    rows = TILE if f32 else _rows_for(seq, batch_heads, sms)
    live_rows = _up(seq, TILE) if f32 else sum(
        _up(min(rows, seq - r0), 16) for r0 in range(0, seq, rows))
    tails = [min(TILE, seq - k0) for k0 in range(0, seq, TILE)]
    return FlashTrainPlan(
        rows, TILE, *(fp32_smem(dn) if f32 else bf16_smem(nt, dn)),
        (-(-seq // rows), batch_heads), nt,
        "fp32_split" if f32 else "bf16", dn, seq * seq,
        live_rows * sum(_up(k, 8) for k in tails),
        live_rows * sum(_up(k, 64 if f32 else 16) for k in tails))


def bf16_smem(q_terms: int, padded_dim: int):
    """Dynamic shared memory of the bf16 forward, dq and dk/dv kernels,
    bytes: 1 KB to align the tiles to the swizzle's period, then tiles of
    64 x padded_dim bf16: the forward's q terms and (K, V) stages; the dq
    kernel's q terms, g and (K, V) stages; the dk/dv kernel's K, V and
    stages of q terms, g and 64 row terms (1 KB)."""
    tile = TILE * padded_dim * 2
    return (1024 + (q_terms + 2 * RING_STAGES) * tile,
            1024 + (q_terms + 1 + 2 * RING_STAGES) * tile,
            1024 + 2 * tile + RING_STAGES * ((q_terms + 1) * tile + 1024))


def fp32_smem(padded_dim: int):
    """Dynamic shared memory of the fp32 forward, dq and dk/dv kernels,
    bytes: 1 KB to align, then groups of three term tiles (64 x padded_dim
    bf16 each): the forward's qs and RING_STAGES stages (of k or v); the
    dq kernel's qs, g and stages; the dk/dv kernel's k, v and stages (of g
    or qs) each with 64 row terms (1 KB)."""
    group = 3 * TILE * padded_dim * 2
    return (1024 + (1 + RING_STAGES) * group,
            1024 + (2 + RING_STAGES) * group,
            1024 + 2 * group + RING_STAGES * (group + 1024))


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


def _terms_scratch(slots, batch_heads, seq, plan, device):
    """The bf16 scratch of `slots` operands' terms, (slots, batch * heads,
    3, seq, padded_dim)."""
    return torch.empty((slots, batch_heads, 3, seq, plan.padded_dim),
                       dtype=torch.bfloat16, device=device)


def _launch_fwd(query, key, value):
    """Launches the forward kernel (no launch counted)."""
    query, key, value = (t.contiguous() for t in (query, key, value))
    batch, heads, seq, d, scale, is_f32, nt = _launch_args(query)
    plan = flash_train_plan(batch * heads, seq, d, query.dtype, SMS)
    o = torch.empty_like(query)
    m = torch.empty((batch, heads, seq), dtype=torch.float32,
                    device=query.device)
    n = torch.empty_like(m)
    # fp32: the terms of k and v
    terms = _terms_scratch(2, batch * heads, seq, plan, query.device) \
        if is_f32 else None
    code = _lib().mha_flash_trainable_fwd(
        query.data_ptr(), key.data_ptr(), value.data_ptr(), o.data_ptr(),
        m.data_ptr(), n.data_ptr(),
        None if terms is None else terms.data_ptr(), batch, heads, seq, d,
        scale, is_f32, nt, _vec(d, query, key, value, o), plan.rows,
        plan.smem_fwd, _stream())
    _raise_on_error("mha_flash_trainable_fwd", code)
    return o, m, n


def _count(name, query):
    LAUNCHES[name] += 1
    if query.dtype == torch.float32:
        FP32_LAUNCHES[name] += 1


def mha_flash_trainable_fwd(query, key, value):
    """(o, m, n): o = softmax(qs k^T) v per head, (batch, seq, heads, d) in
    the inputs' type; m, n the fp32 row max and row sum, (batch, heads,
    seq), the backward's residuals."""
    _check_qkv(query, key, value)
    if _route(query, key, value) == "cpu":
        return mha_flash_trainable_fwd_reference(query, key, value)
    out = _launch_fwd(query, key, value)
    _count("mha_flash_trainable_fwd", query)
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
    plan = flash_train_plan(batch * heads, seq, d, query.dtype, SMS)
    dq, dk, dv = (torch.empty_like(query) for _ in range(3))
    # the dq kernel's row terms for the dk/dv kernel, (-m log2(e), 1 / n,
    # r, 0); in bf16 with three q terms, those terms; in fp32 the terms of
    # k, v, qs and g
    rows = torch.empty((*m.shape, 4), dtype=torch.float32, device=m.device)
    terms = None
    if is_f32:
        terms = _terms_scratch(4, batch * heads, seq, plan, query.device)
    elif nt == 3:
        terms = _terms_scratch(1, batch * heads, seq, plan,
                               query.device)[0]
    code = _lib().mha_flash_trainable_bwd(
        query.data_ptr(), key.data_ptr(), value.data_ptr(), g.data_ptr(),
        m.data_ptr(), n.data_ptr(), rows.data_ptr(),
        None if terms is None else terms.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), batch, heads, seq, d, scale, is_f32,
        nt, _vec(d, query, key, value, g, dq, dk, dv), plan.rows,
        plan.smem_dq, plan.smem_dkdv, _stream())
    _raise_on_error("mha_flash_trainable_bwd", code)
    return dq, dk, dv


def mha_flash_trainable_bwd(query, key, value, g, m, n):
    """(dq, dk, dv) of the forward at (query, key, value) for the output's
    gradient g, from the forward's row stats m, n."""
    _check_qkv(query, key, value)
    if _route(query, key, value, g, m, n) == "cpu":
        return mha_flash_trainable_bwd_reference(query, key, value, g, m, n)
    out = _launch_bwd(query, key, value, g, m, n)
    _count("mha_flash_trainable_bwd", query)
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
