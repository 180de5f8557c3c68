"""One DINOv2 layer over a (B, S, H) batch, forward and backward
(counterpart of hypervla_tpu/ops/dino_layer_train.py::dino_layer_train with
its custom VJP: `_fwd_kernel` without and with residuals, `_bwd_kernel`).

    LN1 -> q/k/v -> attention -> out-proj + LayerScale residual ->
    LN2 -> fc1 + exact GELU -> fc2 + LayerScale residual

The TPU kernel holds a whole layer in VMEM in one call; on Hopper the layer
is composed of hand-written kernels instead. Forward: the row LayerNorm and
the bf16 GEMM with its bias / GELU / LayerScale-residual epilogues of
csrc/dino_layer.cu (which mask the ragged M = B*S and take fc2's W2 in its
(4H, H) layout), and the forward of csrc/fused_attention.cu. The
residual-saving forward is the same launches with the stores on: the
epilogues' second output (hc before the GELU, y1 and y2 before the
LayerScale multiply) and the attention's P, so its output equals the
no-residual forward's bit for bit. Backward, in `_bwd_kernel`'s order and at
its rounding points: the A.B^T products through the same GEMM (bf16 out for
dh and dao, fp32 out for the LayerNorm cotangents dn2 and dn1), the
attention backward of csrc/fused_attention.cu on the stored P and qkv,
writing one fused [dq | dk | dv] buffer, and csrc/layer_backward.cu: the
A^T.B weight gradients (summed over all B*S rows in fp32, rounded once to
bf16), the LayerNorm backward rows, and the LayerScale / GELU / bias passes
with their column sums. The rounding points are the TPU kernel's: LN stats
fp32 with one bf16 rounding, every dot an fp32 sum rounded to bf16 plus the
bf16 bias, softmax fp32, GELU and its derivative exact in fp32 (the TPU
kernel's polynomial erf agrees with erff to 2e-6 before the bf16 rounding,
so a rare one-ulp flip is expected), LayerScale residuals in bf16. The
out-projection's input ao is kept from the forward (25 MB per layer at
B=64) where the TPU kernel recomputes P.V; the values are the same.

`dino_layer_train` keeps the JAX signature and is differentiable
(torch.autograd.Function); called with no gradient asked for it runs the
no-residual forward, as jax.custom_vjp does. The frozen encoder packs each
layer's operands once (`pack_layer_params`) and calls
`dino_layer_train_packed`. A wrapper takes its plain PyTorch version only
for tensors on the CPU; for CUDA tensors it launches its kernels or raises.
A layer call on CUDA tensors adds one to `LAUNCHES["dino_layer_train_fwd"]`
(no residuals), `["dino_layer_train_fwd_res"]` or `["dino_layer_train_bwd"]`;
the attention launches inside a layer are counted there, not under
`mha_fused_train_*`.
"""
import functools
import math
from typing import Callable, Dict, NamedTuple, Optional

import torch

from hypervla_tpu_torch.ops import dino_layer as dl
from hypervla_tpu_torch.ops import fused_attention as fa
from hypervla_tpu_torch.ops import layer_norm as ln

# pv row indices (fp32 per-layer vectors, packed (11, H))
(BQ, BK, BV, BO, B2, LN1_S, LN1_B, LN2_S, LN2_B, LS1, LS2) = range(11)

#: launches since the last reset: the composed layer calls, and each kernel
#: of csrc/layer_backward.cu launched from here
LAUNCHES: Dict[str, int] = {
    "dino_layer_train_fwd": 0, "dino_layer_train_fwd_res": 0,
    "dino_layer_train_bwd": 0, "layer_gemm_tn": 0, "layer_scale_grad": 0,
    "layer_gelu_bwd": 0, "layer_colsum": 0,
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


#: a packed layer's operands, in the order `pack_operands` returns them
OPERANDS = ("wqkv", "bqkv", "wo", "w1", "w2", "pv", "b1")
#: what the residual-saving forward keeps for the backward, in order
RESIDUALS = ("x1", "qkv", "probs", "hc", "y1", "y2", "ao")


def pack_operands(wq, wk, wv, wo, w1, w2, pv, b1):
    """The JAX signature's operands as the layer's launches take them:
    (wqkv (H, 3H), bqkv (3H,), wo, w1, w2, pv, b1 (4H,)), contiguous."""
    pv = pv.contiguous()
    return (torch.cat([wq, wk, wv], dim=1),
            torch.cat([pv[BQ], pv[BK], pv[BV]]), wo.contiguous(),
            w1.contiguous(), w2.contiguous(), pv, b1[0].contiguous())


def _check_args(x, ops, heads):
    wqkv, bqkv, wo, w1, w2, pv, b1 = ops
    b, s, h = x.shape
    mlp = w1.shape[1]
    dl._check(x.dtype == torch.bfloat16, f"x must be bf16, got {x.dtype}")
    for w, shape in ((wqkv, (h, 3 * h)), (wo, (h, h)), (w1, (h, mlp)),
                     (w2, (mlp, h))):
        dl._check(w.dtype == torch.bfloat16 and tuple(w.shape) == shape,
                  f"weight {tuple(w.shape)} {w.dtype}, expected {shape} bf16")
    for v, shape in ((bqkv, (3 * h,)), (pv, (11, h)), (b1, (mlp,))):
        dl._check(v.dtype == torch.float32 and tuple(v.shape) == shape,
                  f"vector {tuple(v.shape)} {v.dtype}, expected {shape} fp32")
    dl._check(h % heads == 0, f"width {h} not divisible by {heads} heads")


# ---------- the backward's kernels, beside their plain versions ----------


def gemm_tn_reference(a, b):
    """bf16(a^T @ b): a (M, K1), b (M, N) bf16, the sum over the M rows in
    fp32, rounded once."""
    return (a.float().t() @ b.float()).bfloat16()


class GemmTnConfig(NamedTuple):
    """A launch of the A^T.B kernel: block_m x block_n outputs a block (128
    x 256 or 64 x 64), the ceil(M / 64) row tiles cut into `split`
    contiguous parts, one block each, whose fp32 partial tiles a finishing
    pass adds in order."""
    block_m: int
    block_n: int
    split: int


#: row tiles a part keeps at least: the depth of the kernel's ring
GEMM_TN_MIN_ROW_TILES = 4


def gemm_tn_blocks_per_wave(config: GemmTnConfig) -> int:
    """Blocks resident at once: one a multiprocessor for the 128 x 256
    tile (196 KB of ring), three for the 64 x 64 one (66 KB)."""
    return dl.GEMM_SMS * (1 if config.block_n == 256 else 3)


def gemm_tn_cost_us(m: int, k1: int, n: int, config: GemmTnConfig) -> float:
    """The model the split is chosen by: the waves of blocks times the
    `wgmma` time of one block's row tiles at the card's bf16 peak, plus,
    with a split, the partial tiles written and read once at the card's
    memory rate."""
    tiles = (k1 // config.block_m) * (n // config.block_n)
    row_tiles = -(-m // 64)
    waves = -(-tiles * config.split // gemm_tn_blocks_per_wave(config))
    per_block = -(-row_tiles // config.split)
    flops = 2 * config.block_m * config.block_n * 64
    sm_peak = 989e12 / dl.GEMM_SMS
    # three 64 x 64 blocks share a multiprocessor's tensor cores
    sharing = 1 if config.block_n == 256 else 3
    cost = waves * per_block * flops * sharing / sm_peak
    if config.split > 1:
        cost += 2 * config.split * k1 * n * 4 / 3.35e12
    return cost * 1e6


@functools.lru_cache(maxsize=None)  # the search costs a launch's time
def gemm_tn_config(m: int, k1: int, n: int) -> GemmTnConfig:
    """The configuration `gemm_tn` launches for a^T (k1, m) x b (m, n).

    Large m takes the 128 x 256 tile where it divides the output, as every
    weight gradient of the flagship layer does; everything else the 64 x 64
    one. The split is the one `gemm_tn_cost_us` makes cheapest among those
    that leave each part at least GEMM_TN_MIN_ROW_TILES row tiles (the
    smaller split on a tie): tiles too few for the card are split until
    their last wave is full, as long as the partial tiles' traffic costs
    less than the idle multiprocessors did. A pure function of the shape,
    so a shape always takes the same split and its result repeats bit for
    bit."""
    large = m > 512 and k1 % 128 == 0 and n % 256 == 0
    block_m, block_n = (128, 256) if large else (64, 64)
    row_tiles = -(-m // 64)
    splits = range(1, max(1, row_tiles // GEMM_TN_MIN_ROW_TILES) + 1)
    return min((GemmTnConfig(block_m, block_n, s) for s in splits),
               key=lambda c: (gemm_tn_cost_us(m, k1, n, c), c.split))


def gemm_tn(a, b, config: Optional[GemmTnConfig] = None):
    """bf16(a^T @ b) on the card; `config` (default: `gemm_tn_config` of
    the shape) lets a measurement try another tile or split."""
    if dl._route(a, b) == "cpu":
        return gemm_tn_reference(a, b)
    for t in (a, b):
        dl._check(t.dim() == 2 and t.dtype == torch.bfloat16
                  and t.is_contiguous() and t.shape[0] == a.shape[0]
                  and t.shape[1] % 64 == 0 and t.data_ptr() % 16 == 0,
                  "a, b must be contiguous (M, 64k) bf16 with equal M, "
                  "16-byte aligned")
    m, k1 = a.shape
    n = b.shape[1]
    config = config or gemm_tn_config(m, k1, n)
    dl._check(k1 % config.block_m == 0 and n % config.block_n == 0
              and (config.block_m, config.block_n) in ((128, 256), (64, 64))
              and 1 <= config.split <= -(-m // 64),
              f"{config} does not fit a ({m}, {k1})^T x ({m}, {n}) product")
    out = torch.empty((k1, n), dtype=torch.bfloat16, device=a.device)
    partial = (torch.empty((config.split, k1, n), dtype=torch.float32,
                           device=a.device) if config.split > 1 else None)
    code = ln._lib().layer_gemm_tn(
        a.data_ptr(), k1, b.data_ptr(), n, out.data_ptr(), m, k1, n,
        config.block_n, config.split,
        None if partial is None else partial.data_ptr(), dl._stream())
    dl._raise_on_error("layer_gemm_tn", code)
    LAUNCHES["layer_gemm_tn"] += 1
    return out


def _check_rows(*tensors):
    for t in tensors:
        dl._check(t.dim() == 2 and t.dtype == torch.bfloat16
                  and t.is_contiguous() and t.shape == tensors[0].shape,
                  "operands must be contiguous (rows, cols) bf16, same shape")


def scale_grad_reference(g, y, layer_scale):
    """The LayerScale backward: dy = g * bf16(ls) in bf16; d ls = sum
    f32(g) f32(y); d bias = sum f32(dy). g, y (rows, cols) bf16."""
    dy = g * layer_scale.bfloat16()
    return dy, (g.float() * y.float()).sum(0), dy.float().sum(0)


def gelu_bwd_reference(hc, dh):
    """h = bf16(gelu(hc)) recomputed; dhc = bf16(gelu'(hc)) * dh in bf16;
    d fc1 bias = sum f32(dhc). Exact GELU and derivative in fp32."""
    xf = hc.float()
    cdf = 0.5 * (1.0 + torch.erf(xf * math.sqrt(0.5)))
    pdf = torch.exp(-0.5 * xf * xf) * (1.0 / math.sqrt(2 * math.pi))
    dhc = (cdf + xf * pdf).bfloat16() * dh
    return (xf * cdf).bfloat16(), dhc, dhc.float().sum(0)


def colsum_reference(a):
    return a.float().sum(0)


class ColsumConfig(NamedTuple):
    """The column-sum kernel's grid: `strips` blocks of 256 columns across,
    the rows cut into `parts` contiguous ranges (one fp32 partial each,
    added by the finishing launch), `warps` warps a block taking a range's
    rows in turn."""
    strips: int
    parts: int
    warps: int


#: the column-sum kernel's blocks: warps, blocks a multiprocessor the grid
#: fills (one wave), rows a part keeps at least (two of each warp's
#: four-row loads)
COLSUM_WARPS, COLSUM_BLOCKS_PER_SM, COLSUM_MIN_ROWS = 8, 4, 64


def colsum_config(rows: int, cols: int) -> ColsumConfig:
    """The grid `colsum` launches for (rows, cols), from the shape alone:
    as many parts as fill one wave of COLSUM_BLOCKS_PER_SM blocks a
    multiprocessor, fewer where a part would keep under COLSUM_MIN_ROWS
    rows. The order of every sum follows, so a shape's sums repeat bit for
    bit."""
    strips = -(-cols // 256)
    parts = max(1, min(rows // COLSUM_MIN_ROWS,
                       dl.SMS * COLSUM_BLOCKS_PER_SM // strips))
    return ColsumConfig(strips, parts, COLSUM_WARPS)


def _colsum_pass(name, fn, rows, cols, device, *ptrs_before_part, sums=1):
    """Launches a pass on the column sum's grid (`colsum_config`) and
    finishes its partials: the (cols,) fp32 column sums, or (sums, cols)
    for a pass with several (its partials (parts, sums, cols))."""
    config = colsum_config(rows, cols)
    shape = (config.parts, cols) if sums == 1 else (config.parts, sums, cols)
    part = torch.empty(shape, dtype=torch.float32, device=device)
    code = fn(*ptrs_before_part, part.data_ptr(), rows, cols, config.parts,
              config.warps, dl._stream())
    dl._raise_on_error(name, code)
    LAUNCHES[name] += 1
    return ln.finish_sums(part)


def _check_rows16(name, *tensors):
    """The 16-byte loads of the passes on the column sum's grid."""
    cols = tensors[0].shape[1]
    dl._check(cols % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors),
              f"{name} takes widths that are multiples of 8 and 16-byte "
              f"aligned rows, got width {cols}")


def colsum(a):
    """fp32 column sums of a (rows, cols) bf16 matrix. On the card the
    width must be a multiple of 8 and the rows 16-byte aligned (the
    kernel's 16-byte loads); the layer's dqkv is 3 x hidden wide."""
    if dl._route(a) == "cpu":
        return colsum_reference(a)
    _check_rows(a)
    _check_rows16("colsum", a)
    return _colsum_pass("layer_colsum", ln._lib().layer_colsum, *a.shape,
                        a.device, a.data_ptr())


def scale_grad(g, y, layer_scale):
    """The LayerScale backward pass on the column sum's grid: the width a
    multiple of 8 and every row and layer_scale 16-byte aligned on the
    card (the layer's always are)."""
    if dl._route(g, y, layer_scale) == "cpu":
        return scale_grad_reference(g, y, layer_scale)
    _check_rows(g, y)
    dl._check(layer_scale.dtype == torch.float32
              and layer_scale.is_contiguous()
              and layer_scale.shape == (g.shape[1],),
              "layer_scale must be (cols,) fp32")
    dy = torch.empty_like(g)
    _check_rows16("scale_grad", g, y, layer_scale, dy)
    sums = _colsum_pass("layer_scale_grad", ln._lib().layer_scale_grad,
                        *g.shape, g.device, g.data_ptr(), y.data_ptr(),
                        layer_scale.data_ptr(), dy.data_ptr(), sums=2)
    return dy, sums[0], sums[1]


def gelu_bwd(hc, dh):
    """The GELU backward pass on the column sum's grid: the width a
    multiple of 8 and every row 16-byte aligned on the card."""
    if dl._route(hc, dh) == "cpu":
        return gelu_bwd_reference(hc, dh)
    _check_rows(hc, dh)
    h, dhc = torch.empty_like(hc), torch.empty_like(hc)
    _check_rows16("gelu_bwd", hc, dh, h, dhc)
    sums = _colsum_pass("layer_gelu_bwd", ln._lib().layer_gelu_bwd,
                        *hc.shape, hc.device, hc.data_ptr(), dh.data_ptr(),
                        h.data_ptr(), dhc.data_ptr())
    return h, dhc, sums


def _attention_fwd_reference(q, k, v, heads, scale, store_p):
    o, probs = fa.mha_fused_train_fwd_reference(q, k, v, heads, scale)
    return o, (probs if store_p else None)


def _attention_bwd_reference(q, k, v, probs, g, heads, scale):
    return torch.cat(fa.mha_fused_train_bwd_reference(
        q, k, v, probs, g, heads, scale), dim=-1)


class _Impl(NamedTuple):
    """The launches a layer is made of: the kernels, or their plain
    versions, so that both run the same composition."""
    layer_norm: Callable
    gemm: Callable
    attention_fwd: Callable
    attention_bwd: Callable
    gemm_tn: Callable
    scale_grad: Callable
    gelu_bwd: Callable
    colsum: Callable
    layer_norm_bwd: Callable


_KERNELS = _Impl(dl.layer_norm_rows, dl.gemm, fa._launch_fwd, fa._launch_bwd,
                 gemm_tn, scale_grad, gelu_bwd, colsum,
                 ln.layer_norm_bwd_rows)
_PLAIN = _Impl(dl.layer_norm_rows_reference, dl.gemm_reference,
               _attention_fwd_reference, _attention_bwd_reference,
               gemm_tn_reference, scale_grad_reference, gelu_bwd_reference,
               colsum_reference, ln.layer_norm_bwd_rows_reference)


# ------------------------------- forward -------------------------------


def _qkv_slices(qkv, h):
    return qkv[..., :h], qkv[..., h:2 * h], qkv[..., 2 * h:]


def _layer(x, ops, heads, eps, impl: _Impl, with_res: bool):
    """(out, residuals): residuals in RESIDUALS order with `with_res`, else
    None. The same launches either way; with_res turns their stores on."""
    wqkv, bqkv, wo, w1, w2, pv, b1 = ops
    b, s, h = x.shape
    rows = x.reshape(b * s, h)

    def with_pre(result):
        return result if with_res else (result, None)

    n1 = impl.layer_norm(rows, pv[LN1_S], pv[LN1_B], eps)
    qkv = impl.gemm(n1, wqkv, bqkv).view(b, s, 3 * h)
    ao, probs = impl.attention_fwd(*_qkv_slices(qkv, h), heads,
                                   1.0 / math.sqrt(h // heads), with_res)
    x1, y1 = with_pre(impl.gemm(ao.reshape(b * s, h), wo, pv[BO], "residual",
                                rows, pv[LS1], with_pre=with_res))
    n2 = impl.layer_norm(x1, pv[LN2_S], pv[LN2_B], eps)
    hid, hc = with_pre(impl.gemm(n2, w1, b1, "gelu", with_pre=with_res))
    out, y2 = with_pre(impl.gemm(hid, w2, pv[B2], "residual", x1, pv[LS2],
                                 with_pre=with_res))
    out = out.view(b, s, h)
    if not with_res:
        return out, None
    return out, (x1.view(b, s, h), qkv, probs, hc.view(b, s, -1),
                 y1.view(b, s, h), y2.view(b, s, h), ao)


def _reference_packed(x, ops, heads: int, eps: float):
    _check_args(x, ops, heads)
    return _layer(x.contiguous(), ops, heads, eps, _PLAIN, False)[0]


def dino_layer_train_reference(x, wq, wk, wv, wo, w1, w2, pv, b1,
                               heads: int, eps: float):
    """Plain PyTorch layer: the kernels' plain versions, in the same order."""
    return _reference_packed(x, pack_operands(wq, wk, wv, wo, w1, w2, pv, b1),
                             heads, eps)


def dino_layer_train_packed(x, ops, heads: int, eps: float):
    """One layer, no-residual forward without autograd, on operands packed
    by `pack_operands`; the launching wrapper (the plain version for CPU
    tensors)."""
    if dl._route(x, *ops) == "cpu":
        return _reference_packed(x, ops, heads, eps)
    _check_args(x, ops, heads)
    out, _ = _layer(x.contiguous(), ops, heads, eps, _KERNELS, False)
    LAUNCHES["dino_layer_train_fwd"] += 1
    return out


def forward_with_residuals_reference(x, ops, heads: int, eps: float):
    _check_args(x, ops, heads)
    return _layer(x.contiguous(), ops, heads, eps, _PLAIN, True)


def forward_with_residuals(x, ops, heads: int, eps: float):
    """The residual-saving forward on packed operands: (out, residuals),
    residuals in RESIDUALS order: x1 (B, S, H), qkv (B, S, 3H), probs
    (B, heads, S, S), hc (B, S, 4H), y1, y2, ao (B, S, H), all bf16."""
    if dl._route(x, *ops) == "cpu":
        return forward_with_residuals_reference(x, ops, heads, eps)
    _check_args(x, ops, heads)
    result = _layer(x.contiguous(), ops, heads, eps, _KERNELS, True)
    LAUNCHES["dino_layer_train_fwd_res"] += 1
    return result


# ------------------------------- backward -------------------------------


def _backward(g, x, ops, residuals, heads, eps, impl: _Impl):
    """`_bwd_kernel`, line by line: (dx (B, S, H) bf16, dwqkv (H, 3H), dwo,
    dw1, dw2 bf16, dpv (11, H) fp32, db1 (4H,) fp32)."""
    wqkv, _, wo, w1, w2, pv, _ = ops
    x1, qkv, probs, hc, y1, y2, ao = residuals
    b, s, h = x.shape
    m = b * s

    def rows(t):
        return t.reshape(m, t.shape[-1])

    g = rows(g)
    # ---- MLP half ----
    dy2, dls2, db2 = impl.scale_grad(g, rows(y2), pv[LS2])
    dh = impl.gemm(dy2, w2, None, transpose_w=True)
    hid, dhc, db1 = impl.gelu_bwd(rows(hc), dh)
    dw2 = impl.gemm_tn(hid, dy2)
    n2 = impl.layer_norm(rows(x1), pv[LN2_S], pv[LN2_B], eps)
    dw1 = impl.gemm_tn(n2, dhc)
    dn2 = impl.gemm(dhc, w1, None, "f32", transpose_w=True)
    dx1, dscale2, dbias2 = impl.layer_norm_bwd(rows(x1), dn2, pv[LN2_S], eps,
                                               g)
    # ---- attention half ----
    dy1, dls1, dbo = impl.scale_grad(dx1, rows(y1), pv[LS1])
    dao = impl.gemm(dy1, wo, None, transpose_w=True)
    dqkv = rows(impl.attention_bwd(*_qkv_slices(qkv, h), probs,
                                   dao.view(b, s, h), heads,
                                   1.0 / math.sqrt(h // heads)))
    dwo = impl.gemm_tn(rows(ao), dy1)
    dbqkv = impl.colsum(dqkv)
    n1 = impl.layer_norm(rows(x), pv[LN1_S], pv[LN1_B], eps)
    dwqkv = impl.gemm_tn(n1, dqkv)
    # dq.wq^T + dk.wk^T + dv.wv^T as one product over K = 3H
    dn1 = impl.gemm(dqkv, wqkv, None, "f32", transpose_w=True)
    dx, dscale1, dbias1 = impl.layer_norm_bwd(rows(x), dn1, pv[LN1_S], eps,
                                              dx1)
    dpv = torch.stack([dbqkv[:h], dbqkv[h:2 * h], dbqkv[2 * h:], dbo, db2,
                       dscale1, dbias1, dscale2, dbias2, dls1, dls2])
    return dx.view(b, s, h), dwqkv, dwo, dw1, dw2, dpv, db1


def _check_backward(g, x, ops, residuals, heads):
    _check_args(x, ops, heads)
    b, s, h = x.shape
    mlp = ops[3].shape[1]
    shapes = {"x1": (b, s, h), "qkv": (b, s, 3 * h),
              "probs": (b, heads, s, s), "hc": (b, s, mlp), "y1": (b, s, h),
              "y2": (b, s, h), "ao": (b, s, h), "g": (b, s, h)}
    for name, t in zip((*RESIDUALS, "g"), (*residuals, g)):
        # probs may be the padded-row view the attention forward returns
        dense = t.is_contiguous() or (name == "probs"
                                      and fa._is_padded_probs(t))
        dl._check(t.dtype == torch.bfloat16 and dense
                  and tuple(t.shape) == shapes[name],
                  f"{name}: {tuple(t.shape)} {t.dtype}, expected contiguous "
                  f"{shapes[name]} bf16")


def layer_backward_reference(g, x, ops, residuals, heads: int, eps: float):
    _check_backward(g, x, ops, residuals, heads)
    return _backward(g, x, ops, residuals, heads, eps, _PLAIN)


def layer_backward(g, x, ops, residuals, heads: int, eps: float):
    """The layer's backward from the output cotangent g (B, S, H) bf16, the
    input x, the packed operands and the forward's residuals."""
    if dl._route(g, x, *ops, *residuals) == "cpu":
        return layer_backward_reference(g, x, ops, residuals, heads, eps)
    _check_backward(g, x, ops, residuals, heads)
    result = _backward(g, x, ops, residuals, heads, eps, _KERNELS)
    LAUNCHES["dino_layer_train_bwd"] += 1
    return result


# ------------------------------- autograd -------------------------------


class _DinoLayerTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wq, wk, wv, wo, w1, w2, pv, b1, heads, eps):
        x = x.contiguous()
        ops = pack_operands(wq, wk, wv, wo, w1, w2, pv, b1)
        out, residuals = forward_with_residuals(x, ops, heads, eps)
        ctx.save_for_backward(x, *ops, *residuals)
        ctx.heads, ctx.eps = heads, eps
        return out

    @staticmethod
    def backward(ctx, g):
        x, *rest = ctx.saved_tensors
        ops, residuals = rest[:len(OPERANDS)], rest[len(OPERANDS):]
        dx, dwqkv, dwo, dw1, dw2, dpv, db1 = layer_backward(
            g.contiguous(), x, ops, residuals, ctx.heads, ctx.eps)
        h = x.shape[-1]
        return (dx, dwqkv[:, :h], dwqkv[:, h:2 * h], dwqkv[:, 2 * h:], dwo,
                dw1, dw2, dpv, db1[None], None, None)


def dino_layer_train(x, wq, wk, wv, wo, w1, w2, pv, b1, heads: int,
                     eps: float):
    """One DINOv2 layer, differentiable.

    x: (B, S, H) bf16; wq/wk/wv/wo: (H, H) bf16; w1: (H, 4H) bf16;
    w2: (4H, H) bf16; pv: (11, H) fp32 packed
    [bq bk bv bo b2 ln1_s ln1_b ln2_s ln2_b ls1 ls2] with the layer scales
    already multiplied by layerscale_value; b1: (1, 4H) fp32.
    Returns (B, S, H) bf16. The gradients are dx bf16, the six weight
    gradients bf16 (summed over the batch in fp32, rounded once), dpv and
    db1 fp32. With no gradient asked for, the call runs the no-residual
    forward and saves nothing.
    """
    operands = (wq, wk, wv, wo, w1, w2, pv, b1)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *operands)):
        return _DinoLayerTrain.apply(x, *operands, heads, eps)
    return dino_layer_train_packed(x, pack_operands(*operands), heads, eps)


def layer_operands(params: Dict[str, torch.Tensor], prefix: str,
                   layerscale_value: float = 1.0):
    """One layer's operands in the JAX signature's order (wq, wk, wv, wo,
    w1, w2 bf16; pv (11, H), b1 (1, 4H) fp32) from its params keyed
    "<prefix>/attention/attention/query/kernel" and so on (Dense kernels in
    (in, out) layout), pv and b1 as hypervla_tpu/models/encoders/
    dinov2.py::_KernelLayerCollection packs them. Differentiable: autograd
    carries the operands' gradients back to the fp32 leaves."""
    def g(name):
        return params[f"{prefix}/{name}"].float()

    att = "attention/attention"
    pv = torch.stack([
        g(f"{att}/query/bias"), g(f"{att}/key/bias"), g(f"{att}/value/bias"),
        g("attention/output/dense/bias"), g("mlp/fc2/bias"),
        g("norm1/scale"), g("norm1/bias"), g("norm2/scale"), g("norm2/bias"),
        layerscale_value * g("layer_scale1/lambda1"),
        layerscale_value * g("layer_scale2/lambda1"),
    ])
    weights = [g(f"{att}/query/kernel"), g(f"{att}/key/kernel"),
               g(f"{att}/value/kernel"), g("attention/output/dense/kernel"),
               g("mlp/fc1/kernel"), g("mlp/fc2/kernel")]
    return (*(w.bfloat16() for w in weights), pv, g("mlp/fc1/bias")[None])


def pack_layer_params(params: Dict[str, torch.Tensor], prefix: str,
                      layerscale_value: float = 1.0):
    """One layer's operands, packed once by `pack_operands` (the frozen
    encoder's)."""
    return pack_operands(*layer_operands(params, prefix, layerscale_value))
