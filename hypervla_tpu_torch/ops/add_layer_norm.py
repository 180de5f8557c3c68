"""Residual add + LayerNorm as one pass, forward and backward (counterpart
of hypervla_tpu/ops/add_layer_norm.py).

    fused_add_ln(x, delta, scale, bias)
        -> (x + delta, LN(x + delta) * scale + bias)
    fused_add_scale_ln(x, delta, ls, scale, bias)
        -> (x + ls * delta, LN(x + ls * delta) * scale + bias)

The second is the whole residual boundary of a DINOv2 layer: the LayerScale
multiply, the residual add and the LayerNorm that reads the new stream. The
Pallas TPU kernels (`_fwd_kernel` / `_bwd_kernel`, `_fwd_scale_kernel` /
`_bwd_scale_kernel`) become one pair of hand-written CUDA kernels,
templated on whether there is a LayerScale vector (csrc/row_kernels.cu:
`row_add_ln_fwd`, `row_add_ln_bwd`): a warp per row where the width allows
it, with kernel 6's grids (`dl.layer_norm_plan`, `tln.layer_norm_bwd_plan`),
and the first block-per-row kernels at other widths. They keep the TPU
kernels' rounding points:
ls is cast to x.dtype, ls * delta and the add are each rounded to x.dtype,
the statistics are flax's fast variance in fp32 from the rounded sum, y is
rounded once. The backward recomputes the statistics from the saved x_new,
takes both cotangents (either may be absent), writes dx_new = inv * (gs -
mean(gs) - xhat * mean(gs * xhat)) + g_xnew rounded once and, with ls,
ddelta = dx_new(fp32) * ls rounded once; without ls the one dx buffer is the
gradient of both x and delta. dscale, dbias and dls are column sums over
all rows: per-block fp32 partials (one per block of the backward's plan)
and one finishing launch in a fixed order (no atomics, so two runs give the
same bits).

Beside each kernel is its plain PyTorch version with the same arithmetic. A
wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises. Each launch adds one to
`LAUNCHES[<name>]`.
"""
from typing import Dict

import torch

from hypervla_tpu_torch.ops import dino_layer as dl
from hypervla_tpu_torch.ops import layer_norm as tln
from hypervla_tpu_torch.ops.dino_layer import (
    _check,
    _raise_on_error,
    _route,
    _stream,
)
from hypervla_tpu_torch.ops.layer_norm import finish_sums, row_lib

#: launches of each wrapper since the last reset
LAUNCHES: Dict[str, int] = {"fused_add_ln_fwd": 0, "fused_add_ln_bwd": 0,
                            "fused_add_scale_ln_fwd": 0,
                            "fused_add_scale_ln_bwd": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _stats(xn, eps):
    """fp32 (x_new, xhat, inv) with the forward's fast variance."""
    xf = xn.float()
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean,
                      min=0.0)
    inv = torch.rsqrt(var + eps)
    return xf, (xf - mean) * inv, inv


def add_ln_fwd_reference(x, delta, ls, scale, bias, eps: float):
    """Plain PyTorch forward over rows. x, delta (rows, d) in one type; ls
    (d,) fp32 or None; scale, bias (d,) fp32. Returns (x_new, y) in
    x.dtype."""
    if ls is not None:
        delta = ls.to(x.dtype) * delta
    xn = x + delta
    _, xhat, _ = _stats(xn, eps)
    return xn, (xhat * scale + bias).to(x.dtype)


def add_ln_bwd_reference(gy, gxn, xn, delta, ls, scale, eps: float):
    """Plain PyTorch backward over rows. gy, gxn: the cotangents of y and
    x_new in xn.dtype, or None. Returns (dx_new, ddelta, dls, dscale,
    dbias); without ls, ddelta is dx_new itself and dls is None."""
    _, xhat, inv = _stats(xn, eps)
    gf = torch.zeros_like(xhat) if gy is None else gy.float()
    gs = gf * scale
    s1 = gs.mean(-1, keepdim=True)
    s2 = (gs * xhat).mean(-1, keepdim=True)
    dxn = inv * (gs - s1 - xhat * s2)
    if gxn is not None:
        dxn = dxn + gxn.float()
    dx = dxn.to(xn.dtype)
    dscale, dbias = (gf * xhat).sum(0), gf.sum(0)
    if ls is None:
        return dx, dx, None, dscale, dbias
    return (dx, (dxn * ls).to(xn.dtype), (dxn * delta.float()).sum(0),
            dscale, dbias)


def _check_rows(*tensors):
    rows, d = tensors[0].shape
    dtype = tensors[0].dtype
    _check(dtype in (torch.bfloat16, torch.float32),
           f"x must be bf16 or fp32, got {dtype}")
    for t in tensors:
        _check(t.is_contiguous() and t.shape == (rows, d)
               and t.dtype == dtype,
               "x, delta and the cotangents must be contiguous (rows, d) of "
               "one type")
    _check(d <= row_lib().row_max_width(),
           f"row width {d} exceeds the row kernel's registers")


def _check_vectors(d, *vectors):
    for t in vectors:
        _check(t.dtype == torch.float32 and t.is_contiguous()
               and t.shape == (d,), "ls, scale, bias must be (d,) fp32")


def _ptr(t):
    return None if t is None else t.data_ptr()


def add_ln_fwd(x, delta, ls, scale, bias, eps: float):
    """The forward kernel over rows (the plain version for CPU tensors)."""
    vectors = (scale, bias) if ls is None else (ls, scale, bias)
    if _route(x, delta, *vectors) == "cpu":
        return add_ln_fwd_reference(x, delta, ls, scale, bias, eps)
    _check_rows(x, delta)
    _check_vectors(x.shape[1], *vectors)
    xn, y = torch.empty_like(x), torch.empty_like(x)
    plan = dl.layer_norm_plan(*x.shape, x, delta, xn, y, *vectors)
    code = row_lib().row_add_ln_fwd(
        x.data_ptr(), delta.data_ptr(), _ptr(ls), scale.data_ptr(),
        bias.data_ptr(), xn.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1],
        float(eps), int(x.dtype == torch.float32), plan.chunks, plan.blocks,
        plan.warps, _stream())
    _raise_on_error("row_add_ln_fwd", code)
    LAUNCHES["fused_add_ln_fwd" if ls is None
             else "fused_add_scale_ln_fwd"] += 1
    return xn, y


def add_ln_bwd(gy, gxn, xn, delta, ls, scale, eps: float):
    """The backward kernel over rows (the plain version for CPU tensors)."""
    given = [t for t in (gy, gxn, delta, ls) if t is not None]
    if _route(xn, scale, *given) == "cpu":
        return add_ln_bwd_reference(gy, gxn, xn, delta, ls, scale, eps)
    _check_rows(xn, *(t for t in (gy, gxn) if t is not None),
                *(() if ls is None else (delta,)))
    _check_vectors(xn.shape[1], scale, *(() if ls is None else (ls,)))
    rows, d = xn.shape
    dxn = torch.empty_like(xn)
    dd = None if ls is None else torch.empty_like(xn)
    plan = tln.layer_norm_bwd_plan(rows, d, xn, dxn, scale, *given)
    part = torch.empty((plan.blocks, 2 if ls is None else 3, d),
                       dtype=torch.float32, device=xn.device)
    code = row_lib().row_add_ln_bwd(
        _ptr(gy), _ptr(gxn), xn.data_ptr(),
        None if ls is None else delta.data_ptr(), _ptr(ls), scale.data_ptr(),
        dxn.data_ptr(), _ptr(dd), part.data_ptr(), rows, d,
        tln.ROWS_PER_BLOCK, float(eps), int(xn.dtype == torch.float32),
        plan.chunks, plan.blocks, plan.warps, _stream())
    _raise_on_error("row_add_ln_bwd", code)
    LAUNCHES["fused_add_ln_bwd" if ls is None
             else "fused_add_scale_ln_bwd"] += 1
    sums = finish_sums(part)
    if ls is None:
        return dxn, dxn, None, sums[0], sums[1]
    return dxn, dd, sums[2], sums[0], sums[1]


class _FusedAddLn(torch.autograd.Function):
    """Both functions: ls is None for fused_add_ln."""

    @staticmethod
    def forward(ctx, x, delta, ls, scale, bias, eps):
        d = x.shape[-1]
        ls_f = None if ls is None else ls.float().contiguous()
        scale_f = scale.float().contiguous()
        xn, y = add_ln_fwd(x.reshape(-1, d).contiguous(),
                           delta.reshape(-1, d).contiguous(), ls_f, scale_f,
                           bias.float().contiguous(), eps)
        ctx.save_for_backward(xn, scale_f,
                              *(() if ls is None
                                else (delta.reshape(-1, d), ls_f)))
        ctx.eps, ctx.shape = eps, x.shape
        ctx.dtypes = (None if ls is None else ls.dtype, scale.dtype,
                      bias.dtype)
        ctx.set_materialize_grads(False)
        return xn.view(x.shape), y.view(x.shape)

    @staticmethod
    def backward(ctx, gxn, gy):
        xn, scale_f, *rest = ctx.saved_tensors
        delta, ls_f = rest if rest else (None, None)

        def rows(g):
            return None if g is None else g.reshape(xn.shape).contiguous()

        dx, dd, dls, dscale, dbias = add_ln_bwd(
            rows(gy), rows(gxn), xn,
            None if delta is None else delta.contiguous(), ls_f, scale_f,
            ctx.eps)
        ls_dtype, scale_dtype, bias_dtype = ctx.dtypes
        return (dx.view(ctx.shape), dd.view(ctx.shape),
                None if dls is None else dls.to(ls_dtype),
                dscale.to(scale_dtype), dbias.to(bias_dtype), None)


def _check_args(x, delta, *vectors):
    _check(x.shape == delta.shape and x.dtype == delta.dtype,
           "x and delta must have one shape and type")
    for t in vectors:
        _check(t.shape == (x.shape[-1],), "ls, scale, bias must be (d,)")


def fused_add_ln(x, delta, scale, bias, eps: float = 1e-6):
    """(x + delta, LayerNorm(x + delta) * scale + bias) in one pass.

    x, delta: (..., d) of one shape and type (bf16 or fp32); scale, bias:
    (d,). Returns (x_new, y) in x.dtype. Differentiable: the gradients of x
    and delta are one buffer, dscale and dbias fp32 column sums cast to the
    params' types."""
    _check_args(x, delta, scale, bias)
    return _FusedAddLn.apply(x, delta, None, scale, bias, eps)


def fused_add_scale_ln(x, delta, ls, scale, bias, eps: float = 1e-6):
    """(x + ls * delta, LayerNorm(x + ls * delta) * scale + bias), one pass.

    x, delta: (..., d) bf16 or fp32; ls: (d,) fp32, the LayerScale vector
    (layerscale_value * lambda1); scale, bias: (d,). Returns (x_new, y) in
    x.dtype. Differentiable in all five tensors."""
    _check_args(x, delta, ls, scale, bias)
    return _FusedAddLn.apply(x, delta, ls, scale, bias, eps)
