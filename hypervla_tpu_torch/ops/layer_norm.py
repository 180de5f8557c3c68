"""The training LayerNorm, forward and backward (counterpart of
hypervla_tpu/ops/layer_norm.py::layer_norm_pallas), the LayerNorm backward
the training layer shares with it, and the one-pass serving LayerNorm
(counterpart of hypervla_tpu/ops/layer_norm.py::layer_norm).

The Pallas TPU kernels `_ln_train_fwd_kernel` / `_ln_train_bwd_kernel`
become hand-written CUDA kernels: the forward is the row LayerNorm of
csrc/dino_layer.cu in the input's type (fp32 fast-variance statistics on the
uncast input, one rounding to x.dtype); the backward is
csrc/layer_backward.cu's `layer_norm_bwd`, which recomputes the statistics
from x, writes dx in x.dtype and leaves per-block column sums of g*xhat and
g that a finishing launch adds in a fixed order (dscale, dbias in fp32; no
atomics, so results repeat bit for bit). Both hold a row in the registers of
one warp where the width allows it (`dl.row_chunks`); other widths take the
block-per-row forward and the block-walk backward. The same backward kernel, with an
fp32 cotangent and dx added in bf16 to a residual gradient, is the layer
backward's (ops/dino_layer_train.py): one source for both uses.

The Pallas TPU kernel `_ln_kernel` of the forward-only serving LayerNorm
becomes csrc/row_kernels.cu's `row_layer_norm`: fp32 statistics on the
uncast input with the two-pass variance mean((x - mean)^2), where the
kernels above take flax's fast variance, and one rounding to x.dtype; a
warp per row where the width allows it (`layer_norm_plan`), a block per row
at the other widths.

Beside each kernel is its plain PyTorch version with the same arithmetic. A
wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises. Each launch adds one to
`LAUNCHES[<name>]`.
"""
import ctypes
import functools
from typing import Dict

import torch

from hypervla_tpu_torch.ops import dino_layer as dl
from hypervla_tpu_torch.ops.dino_layer import (
    _check,
    _raise_on_error,
    _route,
    _stream,
)

#: rows per block of the block-walk backward kernel (its partial sums are
#: per block)
ROWS_PER_BLOCK = 32
#: the warp-per-row backward's grid: blocks a multiprocessor, warps a block
#: (~200 registers a thread: five blocks of two warps fit, so four are one
#: wave; each block leaves one partial of the column sums)
LN_BWD_BLOCKS_PER_SM, LN_BWD_WARPS = 4, 2

#: the one-pass LayerNorm's warp-per-row grid: warps a block (at 257 rows
#: 65 blocks of four warps took less device time than 257 of one, 129 of
#: two or 33 of eight: tools/layer_norm_sweep.py)
LN_ONE_PASS_WARPS = 4

#: launches of each wrapper since the last reset
LAUNCHES: Dict[str, int] = {"layer_norm_pallas_fwd": 0,
                            "layer_norm_pallas_bwd": 0,
                            "layer_norm_bwd_rows": 0,
                            "layer_norm": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _lib():
    """The built backward library, its C signatures declared (built and
    loaded at the first launch, never at import)."""
    from hypervla_tpu_torch.utils.cuda_build import load_library

    lib = load_library("layer_backward.cu")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.layer_gemm_tn.argtypes = [p, i, p, i, p, i, i, i, i, i, p, p]
    lib.layer_norm_bwd_max_width.argtypes = []
    lib.layer_norm_bwd.argtypes = [p, p, p, p, p, p, i, i, i, f, i, i, i, i,
                                   p]
    lib.layer_scale_grad.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.layer_gelu_bwd.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.layer_colsum.argtypes = [p, p, i, i, i, i, p]
    lib.layer_finish_sums.argtypes = [p, p, i, i, p]
    lib.layer_finish_split.argtypes = []
    for fn in (lib.layer_gemm_tn, lib.layer_norm_bwd_max_width,
               lib.layer_norm_bwd, lib.layer_scale_grad, lib.layer_gelu_bwd,
               lib.layer_colsum, lib.layer_finish_sums,
               lib.layer_finish_split):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def row_lib():
    """The built library of the row kernels (csrc/row_kernels.cu: the
    one-pass LayerNorm, the residual add + LayerNorm pair, the exact GELU),
    its C signatures declared."""
    from hypervla_tpu_torch.utils.cuda_build import load_library

    lib = load_library("row_kernels.cu")
    p, i, f, n = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_longlong)
    lib.row_max_width.argtypes = []
    lib.row_layer_norm.argtypes = [p, p, p, p, i, i, f, i, i, i, i, i, p]
    lib.row_add_ln_fwd.argtypes = [p, p, p, p, p, p, p, i, i, f, i, i, i, i,
                                   p]
    lib.row_add_ln_bwd.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, f, i,
                                   i, i, i, p]
    lib.row_gelu.argtypes = [p, p, n, i, i, p]
    for fn in (lib.row_max_width, lib.row_layer_norm, lib.row_add_ln_fwd,
               lib.row_add_ln_bwd, lib.row_gelu):
        fn.restype = ctypes.c_int
    return lib


def finish_sums(part):
    """Adds per-block partial sums (blocks, ...) fp32 over the blocks: the
    finishing launch of every column sum. Warp w of the
    `_lib().layer_finish_split()` warps a column adds parts w, w + that
    width, ... in order, and the warps' sums are added in warp order."""
    out = torch.empty(part.shape[1:], dtype=torch.float32, device=part.device)
    code = _lib().layer_finish_sums(part.data_ptr(), out.data_ptr(),
                                    part.shape[0], out.numel(), _stream())
    _raise_on_error("layer_finish_sums", code)
    return out


# ------------------------------- backward -------------------------------


def layer_norm_bwd_rows_reference(x, g, scale, eps: float, residual=None):
    """Plain PyTorch LayerNorm backward over rows. x (rows, d) bf16 or fp32;
    g (rows, d) any float type; scale (d,) fp32. Returns (dx, dscale,
    dbias): dx in x.dtype, or, with `residual` (rows, d) in x.dtype,
    residual + dx.to(x.dtype) added in x.dtype; dscale, dbias fp32 sums
    over all rows of g*xhat and g."""
    xf, gf = x.float(), g.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    rs = torch.rsqrt(var + eps)
    xhat = (xf - mu) * rs
    dxhat = gf * scale
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = (rs * (dxhat - m1 - xhat * m2)).to(x.dtype)
    if residual is not None:
        dx = residual + dx
    return dx, (gf * xhat).sum(0), gf.sum(0)


def layer_norm_bwd_plan(rows: int, d: int, *tensors) -> dl.RowPlan:
    """The launch `layer_norm_bwd_rows` makes for (rows, d), from the shape
    (and the tensors' alignment) alone; `blocks` is also the number of
    partial column sums the finishing launch adds."""
    chunks = dl.row_chunks(d, *tensors)
    if chunks == 0:
        return dl.RowPlan(0, -(-rows // ROWS_PER_BLOCK), 8)
    return dl.RowPlan(chunks, *dl.row_grid(rows, LN_BWD_BLOCKS_PER_SM,
                                           LN_BWD_WARPS))


def layer_norm_bwd_rows(x, g, scale, eps: float, residual=None):
    """The LayerNorm backward kernel over rows (the plain version for CPU
    tensors). Takes x, g both bf16 or both fp32, or, with `residual`, x and
    residual bf16 and g fp32 (the layer backward's call)."""
    extra = () if residual is None else (residual,)
    if _route(x, g, scale, *extra) == "cpu":
        return layer_norm_bwd_rows_reference(x, g, scale, eps, residual)
    rows, d = x.shape
    for t in (x, g, *extra):
        _check(t.is_contiguous() and t.shape == (rows, d),
               "x, g, residual must be contiguous (rows, d)")
    _check(scale.dtype == torch.float32 and scale.is_contiguous()
           and scale.shape == (d,), "scale must be (d,) fp32")
    _check(d <= _lib().layer_norm_bwd_max_width(),
           f"row width {d} exceeds the backward kernel's registers")
    if residual is not None:
        mode = 0
        _check(x.dtype == residual.dtype == torch.bfloat16
               and g.dtype == torch.float32,
               "with a residual: x, residual bf16 and g fp32")
    else:
        _check(x.dtype == g.dtype
               and x.dtype in (torch.bfloat16, torch.float32),
               f"x and g must both be bf16 or fp32: {x.dtype}, {g.dtype}")
        mode = 1 if x.dtype == torch.bfloat16 else 2
    dx = torch.empty_like(x)
    plan = layer_norm_bwd_plan(rows, d, x, g, scale, dx, *extra)
    part = torch.empty((plan.blocks, 2, d), dtype=torch.float32,
                       device=x.device)
    code = _lib().layer_norm_bwd(
        x.data_ptr(), g.data_ptr(), scale.data_ptr(),
        None if residual is None else residual.data_ptr(), dx.data_ptr(),
        part.data_ptr(), rows, d, ROWS_PER_BLOCK, float(eps), mode,
        plan.chunks, plan.blocks, plan.warps, _stream())
    _raise_on_error("layer_norm_bwd", code)
    LAUNCHES["layer_norm_bwd_rows"] += 1
    sums = finish_sums(part)
    return dx, sums[0], sums[1]


# ---------------------------- the training LN ----------------------------


def layer_norm_pallas_reference(x, scale, bias, eps: float = 1e-6):
    """Plain PyTorch forward: flax nn.LayerNorm fast-variance semantics,
    fp32 statistics on the uncast input, one rounding to x.dtype."""
    return dl.layer_norm_rows_reference(x, scale.float(), bias.float(), eps)


def _check_ln(x, scale, bias):
    _check(x.dtype in (torch.bfloat16, torch.float32),
           f"x must be bf16 or fp32, got {x.dtype}")
    _check(scale.shape == bias.shape == (x.shape[-1],),
           "scale and bias must be (d,)")


class _LayerNormPallas(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        rows = x.reshape(-1, x.shape[-1]).contiguous()
        scale_f = scale.float().contiguous()
        y = dl.layer_norm_rows(rows, scale_f, bias.float().contiguous(), eps)
        if y.is_cuda:
            LAUNCHES["layer_norm_pallas_fwd"] += 1
        ctx.save_for_backward(rows, scale_f)
        ctx.eps, ctx.param_dtype = eps, scale.dtype
        return y.view(x.shape)

    @staticmethod
    def backward(ctx, g):
        rows, scale_f = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_bwd_rows(
            rows, g.reshape(rows.shape).contiguous(), scale_f, ctx.eps)
        if dx.is_cuda:
            LAUNCHES["layer_norm_pallas_bwd"] += 1
        return (dx.view(g.shape), dscale.to(ctx.param_dtype),
                dbias.to(ctx.param_dtype), None)


def layer_norm_pallas(x, scale, bias, eps: float = 1e-6):
    """Differentiable LayerNorm over the last axis. x (..., d) bf16 or fp32;
    scale, bias (d,). Returns x's shape and dtype; the gradients are dx in
    x.dtype and dscale, dbias as fp32 column sums over all rows, cast to
    the params' dtype."""
    _check_ln(x, scale, bias)
    return _LayerNormPallas.apply(x, scale, bias, eps)


# ----------------------- the one-pass serving LN ------------------------


def layer_norm_reference(x, scale, bias, eps: float = 1e-6):
    """Plain PyTorch forward of the one-pass LayerNorm: fp32 statistics on
    the uncast input, the two-pass variance mean((x - mean)^2), one rounding
    to x.dtype."""
    xf = x.float()
    centred = xf - xf.mean(-1, keepdim=True)
    var = (centred * centred).mean(-1, keepdim=True)
    y = centred * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def layer_norm_plan(rows: int, d: int, *tensors) -> dl.RowPlan:
    """The launch `layer_norm` makes for (rows, d), from the shape and the
    tensors' alignment alone: a warp per row (`dl.row_chunks`: widths that
    are multiples of 8 up to 1024, every tensor 16-byte aligned) in blocks
    of LN_ONE_PASS_WARPS warps, as many as give every warp a row, up to
    kernel 6's blocks a multiprocessor (the warps then walk several rows
    each); else a block of 256 threads per row."""
    chunks = dl.row_chunks(d, *tensors)
    if chunks == 0:
        return dl.RowPlan(0, rows, 8)
    blocks = min(-(-rows // LN_ONE_PASS_WARPS), dl.SMS * dl.LN_BLOCKS_PER_SM)
    return dl.RowPlan(chunks, max(1, blocks), LN_ONE_PASS_WARPS)


def layer_norm(x, scale, bias, eps: float = 1e-6):
    """Forward-only LayerNorm over the last axis. x (..., d) bf16 or fp32;
    scale, bias (d,). Returns x's shape and dtype (the caller casts to its
    compute dtype). Like the TPU kernel it has no gradient: an input that
    requires one raises."""
    _check_ln(x, scale, bias)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, scale, bias)):
        raise RuntimeError(
            "the one-pass LayerNorm (fused_layer_norm=True) is forward only: "
            "run it under torch.no_grad(), or train with "
            "fused_layer_norm='pallas_train'")
    if _route(x, scale, bias) == "cpu":
        return layer_norm_reference(x, scale, bias, eps)
    rows = x.reshape(-1, x.shape[-1]).contiguous()
    _check(rows.shape[1] <= row_lib().row_max_width(),
           f"row width {rows.shape[1]} exceeds the row kernel's registers")
    # bf16-stored scale and bias (the serving step's prepared params) go to
    # the kernel as they are: it widens them on read
    if not (scale.dtype == bias.dtype
            and scale.dtype in (torch.bfloat16, torch.float32)):
        scale, bias = scale.float(), bias.float()
    scale, bias = scale.contiguous(), bias.contiguous()
    out = torch.empty_like(rows)
    plan = layer_norm_plan(*rows.shape, rows, scale, bias, out)
    code = row_lib().row_layer_norm(
        rows.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        rows.shape[0], rows.shape[1], float(eps),
        int(x.dtype == torch.float32), int(scale.dtype == torch.float32),
        plan.chunks, plan.blocks, plan.warps, _stream())
    _raise_on_error("row_layer_norm", code)
    LAUNCHES["layer_norm"] += 1
    return out.view(x.shape)
