"""The training slice's CUDA kernels against their plain PyTorch versions,
on the card, at the flagship's widths (S=257, H=12, D=64, width 768):
the fused training attention forward and backward
(csrc/fused_attention.cu), the layer forward without and with residuals
and the layer backward (ops/dino_layer_train.py over csrc/dino_layer.cu,
the attention kernels and csrc/layer_backward.cu), each kernel of
csrc/layer_backward.cu alone at small and ragged shapes, and the training
LayerNorm (ops/layer_norm.py).

Skips where there is no CUDA device. On a GPU host without JAX, skip the
JAX-only conftest: `python -m pytest --noconftest -q
tests/test_torch_train_cuda.py`.
"""
import math

import numpy as np
import pytest
import torch

from hypervla_tpu_torch.ops import dino_layer as dl
from hypervla_tpu_torch.ops import dino_layer_train as dlt
from hypervla_tpu_torch.ops import fused_attention as fa
from hypervla_tpu_torch.ops import layer_norm as tln

pytestmark = pytest.mark.cuda

B, S, H, D = 8, 257, 12, 64
SCALE = 1.0 / math.sqrt(D)


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, device, std=1.0, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=gen) * std).to(device).bfloat16()


def _err(got, ref):
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    return (got - ref).abs().max().item(), ref.abs().max().item()


def _assert_close_but_for_score_flips(got, ref):
    """One bf16 ulp of the output scale, as for every kernel, for all but
    one entry in a thousand, and 2^-3 of the scale for those. The tensor
    cores' fp32 sums differ from cuBLAS's in their last bits, which moves a
    score that lies at a bf16 rounding boundary to the other neighbour; at
    these inputs (scores of magnitude 8 to 32, one bf16 ulp 2^-4 to 2^-3)
    that moves its row's exponentials by several percent. About one score
    in 10^4 does; a wrong kernel moves every entry."""
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    scale = max(ref.abs().max().item(), 1.0)
    diff = (got - ref).abs()
    over = (diff > 2 ** -7 * scale).float().mean().item()
    assert over <= 1e-3, (over, diff.max().item(), scale)
    assert diff.max().item() <= 2 ** -3 * scale, (diff.max().item(), scale)


def test_attention_forward_kernel(device):
    q, k, v = (_randn((B, S, H * D), device, 2.0, seed) for seed in range(3))
    fa.reset_launch_counts()
    o, probs = fa.mha_fused_train_fwd(q, k, v, H, SCALE)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["mha_fused_train_fwd"] == 1
    ref_o, ref_p = fa.mha_fused_train_fwd_reference(q, k, v, H, SCALE)
    for got, ref in ((o, ref_o), (probs, ref_p)):
        _assert_close_but_for_score_flips(got, ref)
    # the second product alone, on the kernel's own P: one bf16 ulp of the
    # output scale (fp32 sums in another order), no exception
    own_o = fa._merge((probs.float() @ fa._heads(v, H)).bfloat16())
    err, scale = _err(o, own_o)
    assert err <= 2 ** -7 * max(scale, 1.0), (err, scale)


def test_attention_forward_strided_qkv(device):
    """q, k, v as column slices of one fused QKV buffer, P store off."""
    qkv = _randn((B, S, 3 * H * D), device, 2.0, seed=4)
    hd = H * D
    q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
    o, probs = fa.mha_fused_train_fwd(q, k, v, H, SCALE, store_p=False)
    torch.cuda.synchronize()
    assert probs is None
    ref, _ = fa.mha_fused_train_fwd_reference(q, k, v, H, SCALE)
    _assert_close_but_for_score_flips(o, ref)


def test_attention_backward_kernel(device):
    q, k, v, g = (_randn((B, S, H * D), device, 2.0, seed)
                  for seed in range(4))
    _, probs = fa.mha_fused_train_fwd_reference(q, k, v, H, SCALE)
    fa.reset_launch_counts()
    got = fa.mha_fused_train_bwd(q, k, v, probs, g, H, SCALE)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["mha_fused_train_bwd"] == 1
    ref = fa.mha_fused_train_bwd_reference(q, k, v, probs, g, H, SCALE)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        err, scale = _err(a, b)
        # ds is rounded to bf16 between products
        assert err <= 2 ** -5 * max(scale, 1.0), (name, err, scale)


def test_attention_autograd_on_the_card(device):
    leaves = [_randn((2, S, H * D), device, 1.0, seed).requires_grad_(True)
              for seed in range(3)]
    g = _randn((2, S, H * D), device, 1.0, seed=5)
    fa.mha_fused_train(*leaves, H, SCALE).backward(g)
    plain = [t.detach() for t in leaves]
    _, probs = fa.mha_fused_train_fwd_reference(*plain, H, SCALE)
    ref = fa.mha_fused_train_bwd_reference(*plain, probs, g, H, SCALE)
    for leaf, r in zip(leaves, ref):
        err, scale = _err(leaf.grad, r)
        assert err <= 2 ** -5 * max(scale, 1.0), (err, scale)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("batch", [1, 3, 64])
@pytest.mark.parametrize("seq", [1, 16, 17, 64, 65, 257])
def test_attention_kernels_over_shapes(device, seq, batch, fused):
    """Forward and backward on the tensor cores at ragged and full tiles:
    q, k, v as slices of one fused buffer or as separate tensors, the P
    store on and off, the backward on the forward's own (padded-row) P and
    on a dense one, every launch twice with the same bits."""
    hd = H * D
    # unit-variance inputs: scores stay under 4 in magnitude, where a score
    # that rounds to its other bf16 neighbour moves P by less than the bound
    if fused:
        qkv = _randn((batch, seq, 3 * hd), device, 1.0, seed=seq)
        q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
    else:
        q, k, v = (_randn((batch, seq, hd), device, 1.0, seq + i)
                   for i in range(3))
    g = _randn((batch, seq, hd), device, 1.0, seed=seq + 7)
    o, probs = fa.mha_fused_train_fwd(q, k, v, H, SCALE)
    torch.cuda.synchronize()
    assert probs.shape == (batch, H, seq, seq)
    assert probs.stride(2) == fa.probs_row_stride(seq)
    ref_o, ref_p = fa.mha_fused_train_fwd_reference(q, k, v, H, SCALE)
    for got, ref in ((o, ref_o), (probs, ref_p)):
        err, scale = _err(got, ref)
        assert err <= 2 ** -7 * max(scale, 1.0), (err, scale)
    o2, p2 = fa.mha_fused_train_fwd(q, k, v, H, SCALE)
    assert torch.equal(o, o2) and torch.equal(probs, p2)
    o3, none = fa.mha_fused_train_fwd(q, k, v, H, SCALE, store_p=False)
    assert none is None and torch.equal(o, o3)

    got = fa.mha_fused_train_bwd(q, k, v, probs, g, H, SCALE)
    torch.cuda.synchronize()
    ref = fa.mha_fused_train_bwd_reference(q, k, v, probs, g, H, SCALE)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        err, scale = _err(a, b)
        assert err <= 2 ** -5 * max(scale, 1.0), (name, err, scale)
    again = fa.mha_fused_train_bwd(q, k, v, probs, g, H, SCALE)
    dense = fa.mha_fused_train_bwd(q, k, v, probs.contiguous(), g, H, SCALE)
    for a, b, c in zip(got, again, dense):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_attention_rejects_long_sequences(device):
    limit = fa._lib().mha_max_seq()
    assert limit >= 257
    q = _randn((1, limit + 1, D), device)
    with pytest.raises(ValueError, match="exceeds"):
        fa.mha_fused_train_fwd(q, q, q, 1, SCALE)
    q = _randn((1, limit, D), device)
    o, _ = fa.mha_fused_train_fwd(q, q, q, 1, SCALE)
    torch.cuda.synchronize()
    err, scale = _err(o, fa.mha_fused_train_fwd_reference(q, q, q, 1,
                                                          SCALE)[0])
    assert err <= 2 ** -7 * max(scale, 1.0), (err, scale)


def test_attention_rejects_other_head_dims(device):
    q = _randn((1, 9, 4 * 32), device)
    with pytest.raises(ValueError, match="heads x 64"):
        fa.mha_fused_train_fwd(q, q, q, 4, SCALE)


def _layer_operands(device, width=768, seed=0):
    rng = np.random.default_rng(seed)

    def t(a, dtype=torch.bfloat16):
        return torch.tensor(np.asarray(a, np.float32)).to(device, dtype)

    weights = [t(rng.standard_normal(s) * 0.02) for s in
               [(width, width)] * 4 + [(width, 4 * width), (4 * width, width)]]
    pv = t(np.concatenate([
        0.02 * rng.standard_normal((5, width)),
        1 + 0.1 * rng.standard_normal((1, width)),
        0.1 * rng.standard_normal((1, width)),
        1 + 0.1 * rng.standard_normal((1, width)),
        0.1 * rng.standard_normal((1, width)),
        0.1 + 0.02 * rng.standard_normal((2, width)),
    ]), torch.float32)
    b1 = t(0.02 * rng.standard_normal((1, 4 * width)), torch.float32)
    return weights, pv, b1


@pytest.mark.parametrize("layers,bound", [(1, 2 ** -6), (12, 0.05)])
def test_layer_forward_kernel(device, layers, bound):
    x = _randn((B, S, 768), device, 0.5)
    ops = [_layer_operands(device, seed=i) for i in range(layers)]
    dlt.reset_launch_counts()
    got, ref = x, x
    for weights, pv, b1 in ops:
        got = dlt.dino_layer_train(got, *weights, pv, b1, H, 1e-6)
        ref = dlt.dino_layer_train_reference(ref, *weights, pv, b1, H, 1e-6)
    torch.cuda.synchronize()
    assert dlt.LAUNCHES["dino_layer_train_fwd"] == layers
    err, scale = _err(got, ref)
    assert err <= bound * max(scale, 1.0), (err, scale)


# ------------------- the kernels of csrc/layer_backward.cu -------------------
# small and ragged: 68 and 99 rows leave partial row blocks and GEMM tiles


# and the flagship layer's four weight gradients at M = 16448 = 257 row tiles
# (the 128 x 256 tile, the rows split over blocks), one with a ragged last
# row tile


@pytest.mark.parametrize("rows,k1,n", [
    (68, 128, 384), (99, 512, 128), (1028, 768, 768), (1028, 128, 384),
    (16448, 3072, 768), (16448, 768, 3072), (16448, 768, 768),
    (16448, 768, 2304), (16485, 768, 768), (16421, 768, 2304)])
def test_gemm_tn_kernel(device, rows, k1, n):
    a = _randn((rows, k1), device, 1.0, 0)
    b = _randn((rows, n), device, 0.1 if rows > 2048 else 1.0, 1)
    dlt.reset_launch_counts()
    got = dlt.gemm_tn(a, b)
    torch.cuda.synchronize()
    assert dlt.LAUNCHES["layer_gemm_tn"] == 1 and got.shape == (k1, n)
    err, scale = _err(got, dlt.gemm_tn_reference(a, b))
    # one rounding of an fp32 sum taken in another order
    assert err <= 2 ** -7 * max(scale, 1.0), (err, scale)
    assert torch.equal(got, dlt.gemm_tn(a, b))  # no atomics: repeats


@pytest.mark.parametrize("config", [
    dlt.GemmTnConfig(128, 256, 1), dlt.GemmTnConfig(128, 256, 5),
    dlt.GemmTnConfig(128, 256, 33), dlt.GemmTnConfig(64, 64, 1),
    dlt.GemmTnConfig(64, 64, 4)])
def test_gemm_tn_kernel_every_tile_and_split(device, config):
    """Both tiles, unsplit and split (33: one row tile a part), on 33 row
    tiles with a ragged last one: each within one rounding of the plain
    version and repeating bit for bit."""
    a = _randn((2100, 256), device, 1.0, 0)
    b = _randn((2100, 512), device, 1.0, 1)
    got = dlt.gemm_tn(a, b, config)
    torch.cuda.synchronize()
    err, scale = _err(got, dlt.gemm_tn_reference(a, b))
    assert err <= 2 ** -7 * max(scale, 1.0), (config, err, scale)
    assert torch.equal(got, dlt.gemm_tn(a, b, config))


@pytest.mark.parametrize("epilogue", ["none", "f32"])
@pytest.mark.parametrize("rows,k,n", [(68, 384, 128), (99, 128, 512)])
def test_gemm_nt_without_bias(device, epilogue, rows, k, n):
    """A.B^T through the GEMM of csrc/dino_layer.cu: bf16 out with no bias
    (dh, dao) and the fp32 sum itself (the LayerNorm cotangents)."""
    a = _randn((rows, k), device, 1.0, 0)
    w = _randn((n, k), device, 0.05, 1)
    got = dl.gemm(a, w, None, epilogue, transpose_w=True)
    torch.cuda.synchronize()
    ref = dl.gemm_reference(a, w, None, epilogue, transpose_w=True)
    assert got.dtype == ref.dtype == (
        torch.float32 if epilogue == "f32" else torch.bfloat16)
    err, scale = _err(got, ref)
    # f32: sums of ~k products in another order; bf16: one ulp
    bound = 1e-5 * k if epilogue == "f32" else 2 ** -7
    assert err <= bound * max(scale, 1.0), (err, scale)


@pytest.mark.parametrize("epilogue", ["gelu", "residual"])
def test_gemm_second_output(device, epilogue):
    """The value before the GELU or the LayerScale multiply, stored beside
    the epilogue's output; the output itself as without the store."""
    rows, k, n = 99, 128, 256
    a = _randn((rows, k), device, 1.0, 0)
    w = _randn((k, n), device, 0.05, 1)
    bias = _randn((n,), device, 0.1, 2).float()
    extra = ((_randn((rows, n), device, 1.0, 3),
              _randn((n,), device, 0.5, 4).float())
             if epilogue == "residual" else (None, None))
    out, pre = dl.gemm(a, w, bias, epilogue, *extra, with_pre=True)
    torch.cuda.synchronize()
    assert torch.equal(out, dl.gemm(a, w, bias, epilogue, *extra))
    assert torch.equal(pre, dl.gemm(a, w, bias))
    ref_out, ref_pre = dl.gemm_reference(a, w, bias, epilogue, *extra,
                                         with_pre=True)
    for got, ref in ((out, ref_out), (pre, ref_pre)):
        err, scale = _err(got, ref)
        assert err <= 2 ** -7 * max(scale, 1.0), (err, scale)


@pytest.mark.parametrize("rows,cols", [(68, 128), (1028, 768), (300, 3072)])
def test_column_sum_passes(device, rows, cols):
    g, y, dh = (_randn((rows, cols), device, 1.0, seed) for seed in range(3))
    ls = _randn((cols,), device, 0.5, 3).float()
    cases = (
        ("layer_scale_grad", dlt.scale_grad, dlt.scale_grad_reference,
         (g, y, ls)),
        ("layer_gelu_bwd", dlt.gelu_bwd, dlt.gelu_bwd_reference, (y, dh)),
        ("layer_colsum", lambda a: (dlt.colsum(a),),
         lambda a: (dlt.colsum_reference(a),), (g,)),
    )
    for name, kern, plain, args in cases:
        dlt.reset_launch_counts()
        got = kern(*args)
        torch.cuda.synchronize()
        assert dlt.LAUNCHES[name] == 1
        for a, b in zip(got, plain(*args)):
            assert a.dtype == b.dtype and a.shape == b.shape
            err, scale = _err(a, b)
            # bf16 outputs: one ulp (erff and expf against torch's); the
            # fp32 column sums: terms in another order, and a one-ulp flip
            # of one bf16 term
            bound = 2 ** -7 if a.dtype == torch.bfloat16 else 2 ** -8
            assert err <= bound * max(scale, 1.0), (name, err, scale)
        again = kern(*args)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), name


@pytest.mark.parametrize("mode", ["layer", "bf16", "fp32"])
@pytest.mark.parametrize("rows,d", [(68, 128), (114, 768), (1028, 768)])
def test_layer_norm_backward_kernel(device, mode, rows, d):
    x = _randn((rows, d), device, 2.0, 0)
    g = _randn((rows, d), device, 1.0, 1)
    scale = (_randn((d,), device, 0.2, 2).float() + 1.0)
    residual = None
    if mode == "layer":
        g, residual = g.float(), _randn((rows, d), device, 1.0, 3)
    elif mode == "fp32":
        x, g = x.float() + 0.001, g.float()
    tln.reset_launch_counts()
    got = tln.layer_norm_bwd_rows(x, g, scale, 1e-6, residual)
    torch.cuda.synchronize()
    assert tln.LAUNCHES["layer_norm_bwd_rows"] == 1
    ref = tln.layer_norm_bwd_rows_reference(x, g, scale, 1e-6, residual)
    err, ref_scale = _err(got[0], ref[0])
    bound = 1e-5 if mode == "fp32" else 2 ** -7
    assert got[0].dtype == x.dtype
    assert err <= bound * max(ref_scale, 1.0), (err, ref_scale)
    for a, b in zip(got[1:], ref[1:]):
        err, ref_scale = _err(a, b)
        assert err <= 1e-6 * rows * max(ref_scale, 1.0), (err, ref_scale)
    again = tln.layer_norm_bwd_rows(x, g, scale, 1e-6, residual)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_training_layer_norm_autograd_on_the_card(device, dtype):
    x = _randn((3, 57, 768), device, 2.0, 0).to(dtype).requires_grad_(True)
    scale = (_randn((768,), device, 0.2, 1).float() + 1.0).requires_grad_(
        True)
    bias = _randn((768,), device, 0.1, 2).float().requires_grad_(True)
    g = _randn((3, 57, 768), device, 1.0, 3).to(dtype)
    tln.reset_launch_counts()
    y = tln.layer_norm_pallas(x, scale, bias, 1e-6)
    y.backward(g)
    torch.cuda.synchronize()
    assert tln.LAUNCHES["layer_norm_pallas_fwd"] == 1
    assert tln.LAUNCHES["layer_norm_pallas_bwd"] == 1
    rows = x.detach().reshape(-1, 768)
    bound = 1e-5 if dtype == torch.float32 else 2 ** -7
    ref_y = tln.layer_norm_pallas_reference(rows, scale.detach(),
                                            bias.detach(), 1e-6)
    err, ref_scale = _err(y.detach().reshape(-1, 768), ref_y)
    assert y.dtype == dtype and err <= bound * max(ref_scale, 1.0)
    ref = tln.layer_norm_bwd_rows_reference(rows, g.reshape(-1, 768),
                                            scale.detach(), 1e-6)
    for leaf, r in zip((x, scale, bias), ref):
        err, ref_scale = _err(leaf.grad.reshape(r.shape), r)
        tol = bound if leaf is x else 1e-4
        assert err <= tol * max(ref_scale, 1.0), (err, ref_scale)


# ------------------------ the layer, with residuals ------------------------


@pytest.mark.parametrize("batch,seq,width,heads", [(4, 17, 128, 2),
                                                   (3, 33, 128, 2),
                                                   (B, S, 768, H)])
def test_layer_residuals_and_backward_kernels(device, batch, seq, width,
                                              heads):
    weights, pv, b1 = _layer_operands(device, width)
    ops = dlt.pack_operands(*weights, pv, b1)
    x = _randn((batch, seq, width), device, 0.5)
    g = _randn((batch, seq, width), device, 1.0, 9)
    dlt.reset_launch_counts()
    out, res = dlt.forward_with_residuals(x, ops, heads, 1e-6)
    torch.cuda.synchronize()
    assert dlt.LAUNCHES["dino_layer_train_fwd_res"] == 1
    # the primal (no residual stores) gives the same bits
    assert torch.equal(out, dlt.dino_layer_train_packed(x, ops, heads, 1e-6))
    ref_out, ref_res = dlt.forward_with_residuals_reference(x, ops, heads,
                                                            1e-6)
    for name, a, b in zip(("out", *dlt.RESIDUALS), (out, *res),
                          (ref_out, *ref_res)):
        err, scale = _err(a, b)
        # a composed layer's bf16 outputs: two ulps
        assert err <= 2 ** -6 * max(scale, 1.0), (name, err, scale)
    # the backward, both on the plain forward's residuals
    got = dlt.layer_backward(g, x, ops, ref_res, heads, 1e-6)
    torch.cuda.synchronize()
    assert dlt.LAUNCHES["dino_layer_train_bwd"] == 1
    ref = dlt.layer_backward_reference(g, x, ops, ref_res, heads, 1e-6)
    names = ("dx", "dwqkv", "dwo", "dw1", "dw2", "dpv", "db1")
    for name, a, b in zip(names, got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        err, scale = _err(a, b)
        cos = torch.nn.functional.cosine_similarity(
            a.double().flatten(), b.double().flatten(), dim=0).item()
        assert err <= 2 ** -6 * max(scale, 1.0), (name, err, scale)
        assert cos > 0.999, (name, cos)
    again = dlt.layer_backward(g, x, ops, ref_res, heads, 1e-6)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_layer_autograd_on_the_card(device):
    """dino_layer_train under autograd launches the residual-saving forward
    and the backward, and hands every operand its gradient."""
    weights, pv, b1 = _layer_operands(device, 128)
    leaves = [_randn((4, 17, 128), device, 0.5), *weights, pv, b1]
    leaves = [t.requires_grad_(True) for t in leaves]
    dlt.reset_launch_counts()
    out = dlt.dino_layer_train(*leaves, 2, 1e-6)
    out.backward(_randn(out.shape, device, 1.0, 5))
    torch.cuda.synchronize()
    assert dlt.LAUNCHES["dino_layer_train_fwd_res"] == 1
    assert dlt.LAUNCHES["dino_layer_train_bwd"] == 1
    assert dlt.LAUNCHES["dino_layer_train_fwd"] == 0
    cpu = [t.detach().cpu().requires_grad_(True) for t in leaves]
    dlt.dino_layer_train(*cpu, 2, 1e-6).backward(
        _randn(out.shape, "cpu", 1.0, 5))
    for leaf, ref in zip(leaves, cpu):
        assert leaf.grad.dtype == leaf.dtype and leaf.grad.shape == leaf.shape
        err, scale = _err(leaf.grad.cpu(), ref.grad)
        assert err <= 2 ** -6 * max(scale, 1.0), (err, scale)
