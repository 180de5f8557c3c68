"""The DINOv2 serving trunk over stacked per-layer weights (bs=1, bf16).

Counterpart of hypervla_tpu/ops/dino_layer.py. The Pallas TPU kernel
`dino_layers_serving` becomes a set of hand-written CUDA kernels
(csrc/dino_layer.cu): a warp-per-row LayerNorm, a bf16 GEMM with a fused
epilogue (bias, GELU or LayerScale residual) and a per-head tensor-core
attention kernel, launched once per layer by `dino_layers_serving`. Each kernel has a plain
PyTorch version here with the same rounding points (the TPU package's
`_serving_layer_body`): every dot is an fp32 matmul of bf16-valued tensors
rounded once to bf16, biases are added in bf16, LayerNorm uses flax's fast
variance in fp32, softmax is fp32, GELU is exact in fp32.

A wrapper takes the plain version only for a tensor on the CPU. For a CUDA
tensor it launches its kernel or raises. Each kernel launch adds one to
`LAUNCHES[<kernel name>]`, and a trunk run on the card adds one to
`LAUNCHES["dino_layers_serving"]`, so a run can show which path it took.
"""
import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional

import torch

HEAD_DIM = 64
# rows of the per-layer p array (fp32 LN / layer-scale parameters)
LN1_S, LN1_B, LN2_S, LN2_B, LS1, LS2 = range(6)
EPILOGUES = {"none": 0, "gelu": 1, "residual": 2, "f32": 3}

#: launches of each CUDA kernel (and of the whole trunk) since the last reset
LAUNCHES: Dict[str, int] = {
    "dino_layer_norm": 0, "dino_gemm": 0, "dino_attention": 0,
    "dino_layers_serving": 0,
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _lib():
    """The built kernel library, its C signatures declared (built and
    loaded at the first launch, never at import)."""
    from hypervla_tpu_torch.utils.cuda_build import load_library

    lib = load_library("dino_layer.cu")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dino_layer_norm.argtypes = [p, p, p, p, i, i, f, i, i, i, i, p]
    lib.dino_gemm.argtypes = [p, i, p, i, i, p, p, p, p, p, i, i, i, i, i,
                              i, p, p]
    lib.dino_attention.argtypes = [p, p, i, i, i, p]
    lib.dino_attention_max_seq.argtypes = []
    for fn in (lib.dino_layer_norm, lib.dino_gemm, lib.dino_attention,
               lib.dino_attention_max_seq):
        fn.restype = ctypes.c_int
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _raise_on_error(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def _route(*tensors) -> str:
    """'cpu' (plain version) or 'cuda' (kernel); raises on anything else."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds == {"cuda"}:
        return "cuda"
    raise ValueError(f"tensors must all lie on the CPU or all on CUDA: {kinds}")


# ------------------------------- LayerNorm -------------------------------


def layer_norm_rows_reference(x, scale, bias, eps: float):
    """flax LayerNorm semantics: fp32 fast-variance stats, fp32 normalize,
    one rounding to x's type. x (rows, d) bf16 or fp32; scale, bias (d,)
    fp32."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


#: multiprocessors of the card the grids are chosen for (H100)
SMS = 132
#: the widest row the warp-per-row kernels hold in a warp's registers
ROW_MAX_WIDTH = 1024


class RowPlan(NamedTuple):
    """The launch of a row kernel. chunks: the 8-value chunks of a row that
    a lane holds (3: widths up to 768, 4: up to 1024), a warp per row; or 0:
    the kernel for the other widths (one block per row forward, a block
    walking a range of rows backward). blocks x warps: the grid of the
    warp-per-row kernel, warp w of the grid walking rows w, w + blocks *
    warps, ..."""
    chunks: int
    blocks: int
    warps: int


def row_chunks(d: int, *tensors) -> int:
    """The chunks a lane holds of a row of width d, or 0 where the
    warp-per-row kernels do not take the row: they load 16 bytes at a time
    (d a multiple of 8, every tensor 16-byte aligned) and keep the row in
    registers (d <= ROW_MAX_WIDTH)."""
    if d % 8 or d > ROW_MAX_WIDTH:
        return 0
    if any(t.data_ptr() % 16 for t in tensors):
        return 0
    return 3 if d <= 768 else 4


def row_grid(rows: int, blocks_per_sm: int, warps: int):
    """(blocks, warps per block) of a warp-per-row kernel over `rows` rows:
    blocks of `warps` warps, as many as give every warp a row, up to
    blocks_per_sm a multiprocessor (the warps then walk several rows each);
    fewer warps a block where that many would leave multiprocessors without
    a block (the serving trunk's 257 rows: 257 blocks of one warp)."""
    warps = max(1, min(warps, rows // SMS))
    return max(1, min(-(-rows // warps), SMS * blocks_per_sm)), warps


#: the LayerNorm forward's grid: blocks a multiprocessor, warps a block
#: (~120 registers a thread: four blocks resident, four waves at most)
LN_BLOCKS_PER_SM, LN_WARPS = 16, 4


def layer_norm_plan(rows: int, d: int, *tensors) -> RowPlan:
    """The launch `layer_norm_rows` makes for (rows, d), from the shape (and
    the tensors' alignment) alone."""
    chunks = row_chunks(d, *tensors)
    if chunks == 0:
        return RowPlan(0, rows, 8)
    return RowPlan(chunks, *row_grid(rows, LN_BLOCKS_PER_SM, LN_WARPS))


def layer_norm_rows(x, scale, bias, eps: float):
    if _route(x, scale, bias) == "cpu":
        return layer_norm_rows_reference(x, scale, bias, eps)
    _check(x.dim() == 2 and x.dtype in (torch.bfloat16, torch.float32)
           and x.is_contiguous(),
           f"x must be contiguous 2-D bf16 or fp32, got {x.dtype} "
           f"{tuple(x.shape)}")
    for t in (scale, bias):
        _check(t.dtype == torch.float32 and t.is_contiguous()
               and t.shape == (x.shape[1],), "scale/bias must be (d,) fp32")
    out = torch.empty_like(x)
    plan = layer_norm_plan(*x.shape, x, scale, bias, out)
    code = _lib().dino_layer_norm(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        x.shape[0], x.shape[1], float(eps), int(x.dtype == torch.float32),
        plan.chunks, plan.blocks, plan.warps, _stream(),
    )
    _raise_on_error("dino_layer_norm", code)
    LAUNCHES["dino_layer_norm"] += 1
    return out


# ---------------------------- GEMM + epilogue ----------------------------


def gemm_reference(a, w, bias, epilogue: str = "none", residual=None,
                   layer_scale=None, transpose_w: bool = False,
                   with_pre: bool = False):
    """bf16(a @ w) + bf16(bias) (no bias with None), then the epilogue.
    a (M, K) bf16; w (K, N) bf16, or (N, K) with transpose_w; bias,
    layer_scale (N,) fp32. Epilogue "f32" returns the fp32 product itself.
    with_pre ("gelu" and "residual" only) also returns the value before the
    epilogue: (out, pre)."""
    wf = w.float().t() if transpose_w else w.float()
    y = a.float() @ wf
    if epilogue == "f32":
        return y
    y = y.bfloat16()
    if bias is not None:
        y = y + bias.bfloat16()
    if epilogue == "gelu":
        yf = y.float()
        out = (yf * (0.5 * (1.0 + torch.erf(yf * math.sqrt(0.5))))).bfloat16()
    elif epilogue == "residual":
        out = residual + layer_scale.bfloat16() * y
    else:
        _check(epilogue == "none", f"unknown epilogue {epilogue!r}")
        return y
    return (out, y) if with_pre else out


#: multiprocessors of the card the configurations are chosen for (H100)
GEMM_SMS = SMS
#: depth of one k-tile of the kernel's shared-memory ring
GEMM_BLOCK_K = 64


class GemmConfig(NamedTuple):
    """A tile of the GEMM kernels: block_m x block_n outputs a block (128 x
    256: the TMA-fed kernel; 64 x 64: the cp.async-fed one), K cut into
    split_k parts whose fp32 partial sums a finishing pass adds (64 x 64
    only)."""
    block_m: int
    block_n: int
    split_k: int


def gemm_config(m: int, n: int, k: int) -> GemmConfig:
    """The configuration `gemm` launches for an (m, k) x (k, n) product.

    Large m (the product is bound by operations) takes the 128 x 256 tile
    where n is a multiple of 256, as every product of the flagship layer is.
    Everything else takes the 64 x 64 tile; small m, where the weight read
    bounds the product and that grid would leave multiprocessors idle, also
    splits K in two, four, ... as long as the grid is under one block a
    multiprocessor, the split divides the k-tiles and each part keeps at
    least four of them."""
    if m > 512 and n % 256 == 0:
        return GemmConfig(128, 256, 1)
    blocks = -(-m // 64) * (n // 64)
    k_tiles = -(-k // GEMM_BLOCK_K)
    split = 1
    while (blocks * split < GEMM_SMS and k_tiles % (2 * split) == 0
           and k_tiles // (2 * split) >= 4):
        split *= 2
    return GemmConfig(64, 64, split)


def gemm(a, w, bias, epilogue: str = "none", residual=None,
         layer_scale=None, transpose_w: bool = False,
         with_pre: bool = False):
    extra = (residual, layer_scale) if epilogue == "residual" else ()
    if bias is not None:
        extra += (bias,)
    if _route(a, w, *extra) == "cpu":
        return gemm_reference(a, w, bias, epilogue, residual, layer_scale,
                              transpose_w, with_pre)
    _check(epilogue in EPILOGUES, f"unknown epilogue {epilogue!r}")
    _check(not with_pre or epilogue in ("gelu", "residual"),
           f"epilogue {epilogue!r} has no value before it to return")
    _check(bias is not None or epilogue in ("none", "f32"),
           f"epilogue {epilogue!r} needs a bias")
    _check(a.dim() == 2 and a.dtype == torch.bfloat16 and a.is_contiguous()
           and a.data_ptr() % 16 == 0,
           "a must be contiguous 2-D bf16, 16-byte aligned")
    _check(w.dim() == 2 and w.dtype == torch.bfloat16 and w.stride(1) == 1
           and w.stride(0) % 8 == 0 and w.data_ptr() % 16 == 0,
           "w must be 2-D bf16 with unit inner stride, 16-byte aligned rows")
    m, k = a.shape
    n = w.shape[0] if transpose_w else w.shape[1]
    _check((w.shape[1] if transpose_w else w.shape[0]) == k,
           f"inner dims differ: a {tuple(a.shape)}, w {tuple(w.shape)}")
    _check(n % 64 == 0 and k % 32 == 0,
           f"need N % 64 == 0, K % 32 == 0: {n}, {k}")
    _check(bias is None or (bias.dtype == torch.float32
                            and bias.is_contiguous() and bias.shape == (n,)
                            and bias.data_ptr() % 16 == 0),
           "bias must be (N,) fp32, 16-byte aligned")
    res_ptr = ls_ptr = None
    if epilogue == "residual":
        _check(residual.dtype == torch.bfloat16 and residual.is_contiguous()
               and residual.shape == (m, n), "residual must be (M, N) bf16")
        _check(layer_scale.dtype == torch.float32
               and layer_scale.is_contiguous() and layer_scale.shape == (n,)
               and layer_scale.data_ptr() % 16 == 0,
               "layer_scale must be (N,) fp32, 16-byte aligned")
        res_ptr, ls_ptr = residual.data_ptr(), layer_scale.data_ptr()
    out = torch.empty((m, n), device=a.device, dtype=(
        torch.float32 if epilogue == "f32" else torch.bfloat16))
    pre = torch.empty_like(out) if with_pre else None
    _launch_gemm(a, w, transpose_w, bias, res_ptr, ls_ptr, out, pre, n,
                 epilogue)
    LAUNCHES["dino_gemm"] += 1
    return (out, pre) if with_pre else out


def _launch_gemm(a, w, transpose_w, bias, res_ptr, ls_ptr, out, pre, n,
                 epilogue):
    """Launches the checked product into `out` (and `pre`): the kernel
    writes their first a.shape[0] rows and nothing past them."""
    m, k = a.shape
    config = gemm_config(m, n, k)
    partial = (torch.empty((config.split_k, m, n), device=a.device,
                           dtype=torch.float32)
               if config.split_k > 1 else None)
    code = _lib().dino_gemm(
        a.data_ptr(), k, w.data_ptr(), w.stride(0), int(transpose_w),
        None if bias is None else bias.data_ptr(), res_ptr, ls_ptr,
        out.data_ptr(), None if pre is None else pre.data_ptr(), m, n, k,
        EPILOGUES[epilogue], config.block_n, config.split_k,
        None if partial is None else partial.data_ptr(), _stream(),
    )
    _raise_on_error("dino_gemm", code)


# ------------------------------- Attention -------------------------------


def attention_reference(qkv):
    """All heads of softmax attention over qkv (S, 3*hidden) bf16 laid out
    [q | k | v], head dim 64 -> (S, hidden) bf16."""
    seq, width = qkv.shape
    hidden = width // 3
    heads = hidden // HEAD_DIM

    def split(t):
        return t.reshape(seq, heads, HEAD_DIM).transpose(0, 1).float()

    q = qkv[:, :hidden] * 0.125  # exact in bf16
    scores = (split(q) @ split(qkv[:, hidden:2 * hidden]).transpose(1, 2))
    scores = scores.bfloat16().float()
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    probs = (e / e.sum(-1, keepdim=True)).bfloat16()
    ao = (probs.float() @ split(qkv[:, 2 * hidden:])).bfloat16()
    return ao.transpose(0, 1).reshape(seq, hidden)


def attention_unexplained_rows(qkv, got, bound: float):
    """How `got` (S, hidden) stands to attention_reference(qkv): (rows over,
    rows unexplained). A row is one query of one head; it is over where an
    entry lies farther than `bound` from the plain version. The plain
    version rounds every score to bf16, so a score whose exact value lies
    at the midpoint of two bf16 neighbours is rounded either way by two
    correct fp32 sums (one that rounds each addition to nearest, as an FMA
    chain does, and one that truncates, as the tensor cores do), and where
    such a score is among the largest of its row the whole row of P moves
    with it. A row over the bound is explained if its output lies within
    `bound` of the plain version's recomputed with some choice of neighbour
    for each of its ambiguous scores: those whose exact value (fp64, on the
    same bf16 inputs) lies within 64 * 2^-23 * sum |q.k terms| of a
    midpoint, the error bound of an fp32 sum of 64 terms whose additions
    may truncate, and which lie within 8 of the row's largest (the
    exponential of a smaller one is under 4e-4 of the largest, and its two
    roundings differ by less than a seventh of that). Every other score
    keeps its one rounding."""
    seq, width = qkv.shape
    hidden = width // 3
    heads = hidden // HEAD_DIM
    ref = attention_reference(qkv)
    diff = (got.float() - ref.float()).abs().reshape(seq, heads, HEAD_DIM)
    over = (diff.amax(-1) > bound).nonzero().tolist()
    unexplained = 0
    for row, head in over:
        cols = slice(head * HEAD_DIM, (head + 1) * HEAD_DIM)
        q = (qkv[row, :hidden][cols] * 0.125).double()
        k = qkv[:, hidden:2 * hidden][:, cols].double()
        v = qkv[:, 2 * hidden:][:, cols].float()
        terms = k * q
        exact = terms.sum(-1)
        tol = HEAD_DIM * 2.0 ** -23 * terms.abs().sum(-1)
        near = exact.float().bfloat16()
        # the bf16 neighbour of `near` on the side of the exact value
        up = (exact > near.double()) == (near >= 0)
        step = torch.where(up, 1, -1).to(torch.int16)
        other = (near.view(torch.int16) + step).view(torch.bfloat16)
        middle = (near.double() + other.double()) / 2
        ambiguous = (((exact - middle).abs() <= tol)
                     & (exact >= exact.max() - 8)).nonzero().flatten()
        if len(ambiguous) > 12:
            unexplained += 1
            continue
        bits = torch.arange(len(ambiguous), device=qkv.device)
        choices = (torch.arange(2 ** len(ambiguous), device=qkv.device)[:, None]
                   >> bits & 1).bool()
        scores = near.float().repeat(len(choices), 1)
        scores[:, ambiguous] = torch.where(
            choices, other[ambiguous].float(), near[ambiguous].float())
        e = torch.exp(scores - scores.amax(-1, keepdim=True))
        probs = (e / e.sum(-1, keepdim=True)).bfloat16()
        outs = (probs.float() @ v).bfloat16().float()
        err = (outs - got[row, cols].float()).abs().amax(-1)
        unexplained += int(not bool((err <= bound).any()))
    return len(over), unexplained


#: the longest row of scores the attention kernel takes: it holds a row's
#: scores in the registers of four key warps, five chunks of 16 keys each
ATTENTION_MAX_SEQ = 320


def attention_warps(heads: int, seq: int) -> int:
    """Row warps (of 16 query rows each) a block of the attention kernel
    takes: four where the 64-row blocks still give every multiprocessor
    one, else two (the serving trunk's 12 heads x 257 rows: 108 blocks of
    32 rows, one a multiprocessor). Every row warp is four key warps."""
    return 4 if heads * -(-seq // 64) >= SMS else 2


def attention_grid(heads: int, seq: int):
    """(heads, blocks a head) of the attention kernel's grid."""
    return heads, -(-seq // (16 * attention_warps(heads, seq)))


def attention(qkv):
    """All heads of softmax attention over a fused qkv buffer of up to
    ATTENTION_MAX_SEQ tokens (longer sequences: the per-layer trunk's flash
    attention, ops/flash_attention.py)."""
    if _route(qkv) == "cpu":
        return attention_reference(qkv)
    _check(qkv.dim() == 2 and qkv.dtype == torch.bfloat16
           and qkv.is_contiguous() and qkv.shape[1] % (3 * HEAD_DIM) == 0
           and qkv.data_ptr() % 16 == 0,
           "qkv must be contiguous (S, 3*hidden) bf16 with hidden % 64 == 0, "
           "16-byte aligned")
    seq, width = qkv.shape
    _check(1 <= seq <= ATTENTION_MAX_SEQ,
           f"a row of {seq} scores does not fit the attention kernel's "
           f"registers (at most {ATTENTION_MAX_SEQ})")
    heads = width // (3 * HEAD_DIM)
    out = torch.empty((seq, width // 3), dtype=torch.bfloat16,
                      device=qkv.device)
    code = _lib().dino_attention(
        qkv.data_ptr(), out.data_ptr(), seq, width // 3,
        attention_warps(heads, seq), _stream()
    )
    _raise_on_error("dino_attention", code)
    LAUNCHES["dino_attention"] += 1
    return out


# --------------------------------- Trunk ---------------------------------


def _run_layers(x, w, b, p, eps, layer_norm_fn, gemm_fn, attention_fn):
    hidden = x.shape[1]
    for i in range(w.shape[0]):
        n = layer_norm_fn(x, p[i, LN1_S], p[i, LN1_B], eps)
        qkv = gemm_fn(n, w[i, 0, :, :3 * hidden], b[i, 0, :3 * hidden])
        ao = attention_fn(qkv)
        x = gemm_fn(ao, w[i, 0, :, 3 * hidden:], b[i, 0, 3 * hidden:],
                    "residual", x, p[i, LS1])
        n = layer_norm_fn(x, p[i, LN2_S], p[i, LN2_B], eps)
        h = gemm_fn(n, w[i, 1], b[i, 1], "gelu")
        # w[i, 2] holds W2^T (hidden, 4*hidden): contract h against its dim 1
        x = gemm_fn(h, w[i, 2], b[i, 2, :hidden], "residual", x, p[i, LS2],
                    True)
    return x


def _check_trunk(x, w, b, p):
    seq, hidden = x.shape
    layers = w.shape[0]
    _check(hidden % HEAD_DIM == 0, f"hidden {hidden} not a multiple of 64")
    _check(tuple(w.shape) == (layers, 3, hidden, 4 * hidden)
           and w.dtype == torch.bfloat16, f"w: {tuple(w.shape)} {w.dtype}")
    _check(tuple(b.shape) == (layers, 3, 4 * hidden)
           and b.dtype == torch.float32, f"b: {tuple(b.shape)} {b.dtype}")
    _check(tuple(p.shape) == (layers, 6, hidden)
           and p.dtype == torch.float32, f"p: {tuple(p.shape)} {p.dtype}")
    for t in (x, w, b, p):
        _check(t.is_contiguous(), "trunk tensors must be contiguous")


def dino_layers_serving_reference(x, w, b, p, eps: float = 1e-6):
    """Plain PyTorch trunk: the kernels' plain versions, layer by layer."""
    x = x.bfloat16()
    _check_trunk(x, w, b, p)
    return _run_layers(x, w, b, p, eps, layer_norm_rows_reference,
                       gemm_reference, attention_reference)


def dino_layers_serving(x, w, b, p, eps: float = 1e-6):
    """Runs the stacked DINOv2 layers over x.

    x: (seq, hidden) bf16, the embedded tokens (batch squeezed outside).
    w: (L, 3, hidden, 4*hidden) bf16: [Wq|Wk|Wv|Wo], W1, W2^T per layer.
    b: (L, 3, 4*hidden) fp32: per-stage biases (fc2's padded to 4*hidden).
    p: (L, 6, hidden) fp32: LN scales/biases and layer scales.
    """
    if _route(x, w, b, p) == "cpu":
        return dino_layers_serving_reference(x, w, b, p, eps)
    _check(x.dtype == torch.bfloat16, f"x must be bf16, got {x.dtype}")
    _check_trunk(x, w, b, p)
    out = _run_layers(x, w, b, p, eps, layer_norm_rows, gemm, attention)
    LAUNCHES["dino_layers_serving"] += 1
    return out


# ------------------------------- Stacking --------------------------------


def stack_serving_layer_params(layer_params: Dict[str, torch.Tensor],
                               layerscale_value: float = 1.0,
                               device: Optional[torch.device] = None):
    """Builds the trunk's (w, b, p) stacks from per-layer params keyed
    "<i>/attention/attention/query/kernel" and so on (the JAX package's
    encoder/layer subtree, Dense kernels in (in, out) layout). Runs once
    per episode, off the per-tick path. p rows follow
    (LN1_S, LN1_B, LN2_S, LN2_B, LS1, LS2)."""
    num_layers = 1 + max(int(k.split("/", 1)[0]) for k in layer_params)
    ws, bs, ps = [], [], []
    for i in range(num_layers):
        def g(name, i=i):
            return layer_params[f"{i}/{name}"].to(device).float()

        att = "attention/attention"
        hidden = g("norm1/scale").shape[0]
        w0 = torch.cat([g(f"{att}/query/kernel"), g(f"{att}/key/kernel"),
                        g(f"{att}/value/kernel"),
                        g("attention/output/dense/kernel")], dim=1)
        ws.append(torch.stack([w0, g("mlp/fc1/kernel"),
                               g("mlp/fc2/kernel").t()]))
        b0 = torch.cat([g(f"{att}/query/bias"), g(f"{att}/key/bias"),
                        g(f"{att}/value/bias"),
                        g("attention/output/dense/bias")])
        pad = torch.zeros(3 * hidden, device=b0.device)
        bs.append(torch.stack([b0, g("mlp/fc1/bias"),
                               torch.cat([g("mlp/fc2/bias"), pad])]))
        ps.append(torch.stack([
            g("norm1/scale"), g("norm1/bias"),
            g("norm2/scale"), g("norm2/bias"),
            layerscale_value * g("layer_scale1/lambda1"),
            layerscale_value * g("layer_scale2/lambda1"),
        ]))
    return (torch.stack(ws).bfloat16().contiguous(), torch.stack(bs),
            torch.stack(ps))
