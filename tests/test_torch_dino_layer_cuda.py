"""The port's CUDA trunk kernels against their plain PyTorch versions, on
the card, at the flagship's shapes (dinov2-base: seq 257, width 768).

Skips where there is no CUDA device. On a GPU host without JAX, skip the
JAX-only conftest: `python -m pytest --noconftest -q
tests/test_torch_dino_layer_cuda.py`.
"""
import math

import numpy as np
import pytest
import torch

from hypervla_tpu_torch.ops import dino_layer as dl
from test_torch_harness import torch_threads  # noqa: F401

pytestmark = pytest.mark.cuda

SEQ, HIDDEN = 257, 768


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _trunk_inputs(layers, device, seed=0):
    rng = np.random.default_rng(seed)

    def t(a, dtype=torch.float32):
        return torch.tensor(a.astype(np.float32), dtype=dtype, device=device)

    x = t(rng.standard_normal((SEQ, HIDDEN)) * 0.5, torch.bfloat16)
    w = t(rng.standard_normal((layers, 3, HIDDEN, 4 * HIDDEN)) * 0.02,
          torch.bfloat16)
    b = t(rng.standard_normal((layers, 3, 4 * HIDDEN)) * 0.02)
    p = np.concatenate([
        1 + 0.1 * rng.standard_normal((layers, 1, HIDDEN)),
        0.1 * rng.standard_normal((layers, 1, HIDDEN)),
        1 + 0.1 * rng.standard_normal((layers, 1, HIDDEN)),
        0.1 * rng.standard_normal((layers, 1, HIDDEN)),
        0.1 + 0.02 * rng.standard_normal((layers, 2, HIDDEN)),
    ], axis=1)
    return x, w, b, t(p)


def _err(got, ref):
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    return (got - ref).abs().max().item(), ref.abs().max().item()


def test_layer_norm_kernel(device):
    x, _, _, p = _trunk_inputs(1, device)
    got = dl.layer_norm_rows(x, p[0, 0], p[0, 1], 1e-6)
    torch.cuda.synchronize()
    err, scale = _err(got, dl.layer_norm_rows_reference(x, p[0, 0], p[0, 1],
                                                        1e-6))
    # one bf16 ulp where the fp32 statistics round differently
    assert err <= 2 ** -7 * max(scale, 1.0), (err, scale)


# (rows, d): the trunk's shapes, a row count that is no multiple of a block's
# warps, the 4-chunk instantiation, narrow rows with idle lanes; then widths
# the warp-per-row kernel does not take (no multiple of 8; wider than 1024)
LN_SHAPES = [(257, 768, 3), (16448, 768, 3), (1001, 768, 3), (77, 1024, 4),
             (130, 128, 3), (68, 96, 3), (5, 8, 3), (68, 100, 0),
             (300, 2048, 0), (9, 1032, 0)]


@pytest.mark.parametrize("shift", [0.0, 1.0])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,d,chunks", LN_SHAPES)
def test_layer_norm_kernel_over_shapes(device, rows, d, chunks, dtype, shift):
    """The warp-per-row kernel and the block-per-row kernel, each at the
    widths the wrapper gives it, bf16 and fp32, on a shifted input too (the
    fast variance cancels there, so the order of a row's sums shows), and
    twice for the same bits."""
    gen = torch.Generator().manual_seed(rows + d)
    x = (torch.randn(rows, d, generator=gen) * 0.5 + shift).to(device).to(
        dtype)
    scale = (1 + 0.1 * torch.randn(d, generator=gen)).to(device)
    bias = (0.1 * torch.randn(d, generator=gen)).to(device)
    assert dl.layer_norm_plan(rows, d, x, scale, bias).chunks == chunks
    dl.reset_launch_counts()
    got = dl.layer_norm_rows(x, scale, bias, 1e-6)
    torch.cuda.synchronize()
    assert dl.LAUNCHES["dino_layer_norm"] == 1
    err, ref_scale = _err(got, dl.layer_norm_rows_reference(x, scale, bias,
                                                            1e-6))
    bound = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
    assert got.dtype == dtype and err <= bound * max(ref_scale, 1.0), err
    assert torch.equal(got, dl.layer_norm_rows(x, scale, bias, 1e-6))


def test_layer_norm_kernel_unaligned_rows_take_the_first_kernel(device):
    x, _, _, p = _trunk_inputs(1, device)
    odd = torch.empty(SEQ * HIDDEN + 1, dtype=x.dtype, device=device)[1:]
    odd = odd.view(SEQ, HIDDEN).copy_(x)
    assert odd.data_ptr() % 16 and odd.is_contiguous()
    assert dl.layer_norm_plan(SEQ, HIDDEN, odd).chunks == 0
    got = dl.layer_norm_rows(odd, p[0, 0], p[0, 1], 1e-6)
    torch.cuda.synchronize()
    err, scale = _err(got, dl.layer_norm_rows_reference(x, p[0, 0], p[0, 1],
                                                        1e-6))
    assert err <= 2 ** -7 * max(scale, 1.0), (err, scale)


@pytest.mark.parametrize("which", ["qkv", "out_proj", "fc1", "fc2"])
def test_gemm_kernel(device, which):
    x, w, b, p = _trunk_inputs(1, device)
    h = HIDDEN
    a_wide = (torch.randn(SEQ, 4 * h, device=device) * 0.5).bfloat16()
    cases = {
        "qkv": (x, w[0, 0, :, :3 * h], b[0, 0, :3 * h], "none", {}),
        "out_proj": (x, w[0, 0, :, 3 * h:], b[0, 0, 3 * h:], "residual",
                     dict(residual=x, layer_scale=p[0, dl.LS1])),
        "fc1": (x, w[0, 1], b[0, 1], "gelu", {}),
        "fc2": (a_wide, w[0, 2], b[0, 2, :h], "residual",
                dict(residual=x, layer_scale=p[0, dl.LS2],
                     transpose_w=True)),
    }
    a, wt, bias, epi, kw = cases[which]
    got = dl.gemm(a, wt, bias, epi, **kw)
    torch.cuda.synchronize()
    ref = dl.gemm_reference(a, wt, bias, epi, **kw)
    err, scale = _err(got, ref)
    # fp32 sums in another order: at most one bf16 ulp after rounding
    assert err <= 2 ** -7 * max(scale, 1.0), (which, err, scale)


def _assert_one_ulp_but_for_ambiguous_scores(qkv, got):
    """Every row (a query of a head) within one bf16 ulp of the output scale
    of the plain version, but those that a score at the midpoint of two bf16
    values explains: the tensor cores' fp32 sums and the plain version's
    differ in their last bits and may round such a score to either
    neighbour, and a row led by it moves with it. Such a row is held, at
    the same bound, to the plain version recomputed with the other
    neighbour (dl.attention_unexplained_rows)."""
    assert torch.isfinite(got.float()).all()
    scale = dl.attention_reference(qkv).float().abs().max().item()
    bound = 2 ** -7 * max(scale, 1.0)
    over, unexplained = dl.attention_unexplained_rows(qkv, got, bound)
    assert unexplained == 0, (over, unexplained, bound)
    # a wrong kernel moves every row; a boundary score a few in a thousand
    rows = qkv.shape[0] * qkv.shape[1] // (3 * dl.HEAD_DIM)
    assert over <= max(1, rows // 200), (over, rows)


def _ulp_bound(scale):
    """One bf16 ulp at the output's largest magnitude (a power of two)."""
    return 2 ** -7 * 2 ** math.ceil(math.log2(max(scale, 1.0)))


GEMM_CASES = [(epi, tw, pre) for epi in ("none", "gelu", "residual", "f32")
              for tw in (False, True)
              for pre in ((False, True) if epi in ("gelu", "residual")
                          else (False,))]


def _check_gemm(device, m, n, k, epilogue, transpose_w, with_pre,
                with_bias=True):
    """One product against its plain version (one bf16 ulp; for the fp32
    output, sums of k products in another order), and twice for the same
    bits."""
    gen = torch.Generator().manual_seed(m)

    def randn(shape, std, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen) * std).to(device).to(dtype)

    a = randn((m, k), 1.0)
    w = randn((n, k) if transpose_w else (k, n), 0.03)
    bias = (randn((n,), 0.1, torch.float32)
            if with_bias and epilogue != "f32" else None)
    kw = dict(transpose_w=transpose_w)
    if epilogue == "residual":
        kw.update(residual=randn((m, n), 1.0),
                  layer_scale=randn((n,), 0.5, torch.float32))
    if with_pre:
        kw.update(with_pre=True)
    got = dl.gemm(a, w, bias, epilogue, **kw)
    torch.cuda.synchronize()
    ref = dl.gemm_reference(a, w, bias, epilogue, **kw)
    again = dl.gemm(a, w, bias, epilogue, **kw)
    if not with_pre:
        got, ref, again = (got,), (ref,), (again,)
    for g_, r_, a_ in zip(got, ref, again):
        assert g_.dtype == r_.dtype and g_.shape == r_.shape
        err, scale = _err(g_, r_)
        bound = 1e-5 * k * max(scale, 1.0) if epilogue == "f32" \
            else _ulp_bound(scale)
        assert err <= bound, (err, scale)
        assert torch.equal(g_, a_)


@pytest.mark.parametrize("epilogue,transpose_w,with_pre", GEMM_CASES)
@pytest.mark.parametrize("m", [1, 63, 64, 65, 257, 16448])
def test_gemm_kernel_over_shapes(device, m, epilogue, transpose_w, with_pre):
    """The pipelined tensor-core GEMM at ragged and full row tiles, both
    kernels and the split-K configurations, every epilogue, both layouts
    of the weight, the second output on and off, no bias where the
    epilogue allows it (at odd m), the fp32 output."""
    k = 4 * HIDDEN if m == 257 and transpose_w else HIDDEN
    _check_gemm(device, m, HIDDEN, k, epilogue, transpose_w, with_pre,
                with_bias=not (epilogue == "none" and m % 2))


@pytest.mark.parametrize("m", [1, 65, 257, 16448])
def test_gemm_leaves_rows_past_m_alone(device, m):
    """The last row tile is ragged at every tile height: the kernel writes
    M rows of `out` and of the second output and nothing after them."""
    n = k = HIDDEN
    a = torch.randn(m, k, device=device).bfloat16()
    w = (torch.randn(k, n, device=device) * 0.03).bfloat16()
    bias = torch.randn(n, device=device) * 0.1
    out = torch.full((m + 1, n), 777.0, device=device, dtype=torch.bfloat16)
    pre = torch.full((m + 1, n), 777.0, device=device, dtype=torch.bfloat16)
    dl._launch_gemm(a, w, False, bias, None, None, out, pre, n, "gelu")
    torch.cuda.synchronize()
    ref_out, ref_pre = dl.gemm_reference(a, w, bias, "gelu", with_pre=True)
    for got, ref in ((out, ref_out), (pre, ref_pre)):
        assert bool((got[m] == 777.0).all())
        err, scale = _err(got[:m], ref)
        assert err <= _ulp_bound(scale), (err, scale)


def test_gemm_config_is_what_the_kernel_takes(device):
    """Every configuration the chooser can return launches: the TMA-fed
    128 x 256 tile, the 64 x 64 tile at small and large M, split-K 2 and 4,
    a K that is no multiple of the 64-deep k-tile."""
    seen = set()
    for m, n, k in ((16448, 768, 768), (1028, 384, 128), (600, 128, 96),
                    (257, 2304, 768), (257, 768, 768), (257, 768, 3072),
                    (600, 192, 96), (5, 64, 32)):
        seen.add(dl.gemm_config(m, n, k))
        _check_gemm(device, m, n, k, "none", False, False, with_bias=False)
    assert seen == {(128, 256, 1), (64, 64, 1), (64, 64, 2), (64, 64, 4)}


@pytest.mark.parametrize("epilogue,transpose_w,with_pre", GEMM_CASES)
def test_gemm_kernels_ragged_k(device, epilogue, transpose_w, with_pre):
    """Both kernels at a K that is no multiple of the 64-deep k-tile (the
    last tile's columns past K are zero-filled) and a ragged last row tile,
    through every epilogue and both layouts of the weight."""
    for (m, n, k), tile in (((1028, 512, 224), (128, 256, 1)),
                            ((1028, 384, 224), (64, 64, 1))):
        assert dl.gemm_config(m, n, k) == tile
        _check_gemm(device, m, n, k, epilogue, transpose_w, with_pre)


def test_attention_kernel(device):
    qkv = (torch.randn(SEQ, 3 * HIDDEN, device=device) * 2.0).bfloat16()
    got = dl.attention(qkv)
    torch.cuda.synchronize()
    _assert_one_ulp_but_for_ambiguous_scores(qkv, got)


@pytest.mark.parametrize("hidden", [64, 128, 768])
@pytest.mark.parametrize("seq", [1, 16, 17, 64, 65, 257, 300, 320])
def test_attention_kernel_over_shapes(device, seq, hidden):
    """Ragged last query and key tiles, key shares that are empty or end
    before S, one, two and twelve heads, against the plain version within
    one bf16 ulp of the output scale, and twice for the same bits."""
    gen = torch.Generator().manual_seed(seq * hidden)
    qkv = (torch.randn(seq, 3 * hidden, generator=gen) * 2.0).to(
        device).bfloat16()
    dl.reset_launch_counts()
    got = dl.attention(qkv)
    torch.cuda.synchronize()
    assert dl.LAUNCHES["dino_attention"] == 1
    _assert_one_ulp_but_for_ambiguous_scores(qkv, got)
    assert torch.equal(got, dl.attention(qkv))


def test_attention_kernel_over_draws(device):
    """Fifty unseeded draws at the serving shape: no row beyond one ulp
    that a score at a rounding midpoint does not explain."""
    for _ in range(50):
        qkv = (torch.randn(SEQ, 3 * HIDDEN, device=device) * 2.0).bfloat16()
        _assert_one_ulp_but_for_ambiguous_scores(qkv, dl.attention(qkv))


def test_attention_kernel_with_four_row_warps(device):
    """Enough heads that a block takes four row warps (sixteen warps)."""
    heads = 44
    assert dl.attention_warps(heads, SEQ) == 4
    qkv = (torch.randn(SEQ, 3 * 64 * heads, device=device) * 2.0).bfloat16()
    got = dl.attention(qkv)
    torch.cuda.synchronize()
    _assert_one_ulp_but_for_ambiguous_scores(qkv, got)


def test_attention_limit_is_the_kernels(device):
    assert dl._lib().dino_attention_max_seq() == dl.ATTENTION_MAX_SEQ
    qkv = torch.zeros(dl.ATTENTION_MAX_SEQ + 1, 3 * 64,
                      device=device).bfloat16()
    with pytest.raises(ValueError, match="registers"):
        dl.attention(qkv)


@pytest.mark.parametrize("layers,bound", [(1, 0.01), (12, 0.05)])
def test_trunk_kernel(device, layers, bound):
    x, w, b, p = _trunk_inputs(layers, device)
    dl.reset_launch_counts()
    got = dl.dino_layers_serving(x, w, b, p)
    torch.cuda.synchronize()
    assert dl.LAUNCHES["dino_layers_serving"] == 1
    assert dl.LAUNCHES["dino_gemm"] == 4 * layers
    err, scale = _err(got, dl.dino_layers_serving_reference(x, w, b, p))
    # the bounds JAX holds between its own trunks
    # (tests/test_dino_layer_kernel.py: 0.01 at 2 layers, 0.05 at 12)
    assert err < bound * max(scale, 1.0), (err, scale)
