"""The port's row kernels (csrc/row_kernels.cu: the one-pass LayerNorm, the
residual add + LayerNorm pair forward and backward, the exact GELU) and its
flash attention (csrc/flash_attention.cu) against their plain PyTorch
versions, on the card, at small, ragged and flagship shapes.

Skips where there is no CUDA device. On a GPU host without JAX, skip the
JAX-only conftest: `python -m pytest --noconftest -q
tests/test_torch_row_flash_cuda.py`.

Bounds: one ulp of the output's type at the output's scale where both sides
compute in fp32 and round once (2^-7 for bf16; 1e-5 for fp32, where only
the order of the sums differs); column sums over the rows relative to their
largest value (1e-4: fp32 sums in another order, and a term whose bf16
neighbour flipped).
"""
import numpy as np
import pytest
import torch

from hypervla_tpu_torch.ops import add_layer_norm as aln
from hypervla_tpu_torch.ops import flash_attention as fa
from hypervla_tpu_torch.ops import gelu as tg
from hypervla_tpu_torch.ops import layer_norm as tln

pytestmark = pytest.mark.cuda

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(rng, shape, dtype, device, scale=1.0):
    return torch.tensor((rng.standard_normal(shape) * scale).astype(
        np.float32), dtype=dtype, device=device)


def _close(got, ref, dtype, what=""):
    got, ref = got.float(), ref.float()
    assert got.shape == ref.shape and torch.isfinite(got).all(), what
    err = (got - ref).abs().max().item()
    scale = max(ref.abs().max().item(), 1.0)
    tol = (2 ** -7 if dtype == torch.bfloat16 else 1e-5) * scale
    assert err <= tol, (what, err, tol)


def _sums_close(got, ref, what=""):
    err = (got - ref).abs().max().item()
    assert err <= 1e-4 * max(ref.abs().max().item(), 1.0), (what, err)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(257, 768), (3, 5, 48), (7, 2048), (1, 1)])
def test_layer_norm_kernel(device, dtype, shape):
    rng = np.random.default_rng(0)
    x = _t(rng, shape, DTYPES[dtype], device, 2.0) + 3.0
    scale = _t(rng, shape[-1:], torch.float32, device, 0.1) + 1.0
    bias = _t(rng, shape[-1:], torch.float32, device, 0.1)
    tln.reset_launch_counts()
    got = tln.layer_norm(x, scale, bias, 1e-6)
    torch.cuda.synchronize()
    assert tln.LAUNCHES["layer_norm"] == 1 and got.dtype == x.dtype
    _close(got, tln.layer_norm_reference(x, scale, bias, 1e-6), x.dtype)
    # bf16-stored scale and bias, as the serving step hands them over
    s16, b16 = scale.bfloat16(), bias.bfloat16()
    _close(tln.layer_norm(x, s16, b16, 1e-6),
           tln.layer_norm_reference(x, s16, b16, 1e-6), x.dtype)


def test_layer_norm_kernel_refuses_wide_rows_and_grads(device):
    x = torch.zeros((2, 2049), device=device)
    ones = torch.ones(2049, device=device)
    with pytest.raises(ValueError, match="width"):
        tln.layer_norm(x, ones, ones)
    x = torch.zeros((2, 8), device=device, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward only"):
        tln.layer_norm(x, ones[:8], ones[:8])


def _add_ln_inputs(rng, shape, dtype, device, with_ls):
    x = _t(rng, shape, dtype, device, 2.0)
    delta = _t(rng, shape, dtype, device)
    d = shape[-1]
    ls = (_t(rng, (d,), torch.float32, device, 0.05) + 0.3
          if with_ls else None)
    scale = _t(rng, (d,), torch.float32, device, 0.1) + 1.0
    bias = _t(rng, (d,), torch.float32, device, 0.1)
    return x, delta, ls, scale, bias


@pytest.mark.parametrize("with_ls", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(114, 768), (33, 48), (65, 2048)])
def test_add_ln_kernels(device, dtype, shape, with_ls):
    rng = np.random.default_rng(1)
    dt = DTYPES[dtype]
    x, delta, ls, scale, bias = _add_ln_inputs(rng, shape, dt, device,
                                               with_ls)
    aln.reset_launch_counts()
    xn, y = aln.add_ln_fwd(x, delta, ls, scale, bias, 1e-6)
    torch.cuda.synchronize()
    ref_xn, ref_y = aln.add_ln_fwd_reference(x, delta, ls, scale, bias, 1e-6)
    assert torch.equal(xn, ref_xn)  # the same roundings: the same bits
    _close(y, ref_y, dt, "y")

    gy, gxn = _t(rng, shape, dt, device), _t(rng, shape, dt, device)
    for cot in ((gy, gxn), (gy, None), (None, gxn)):
        got = aln.add_ln_bwd(*cot, ref_xn, delta, ls, scale, 1e-6)
        torch.cuda.synchronize()
        again = aln.add_ln_bwd(*cot, ref_xn, delta, ls, scale, 1e-6)
        ref = aln.add_ln_bwd_reference(*cot, ref_xn, delta, ls, scale, 1e-6)
        for name, a, b, c in zip(("dx", "ddelta", "dls", "dscale", "dbias"),
                                 got, again, ref):
            if c is None:
                assert a is None, name
                continue
            assert torch.equal(a, b), name  # two runs: the same bits
            if name in ("dx", "ddelta"):
                _close(a, c, dt, name)
            else:
                _sums_close(a, c, name)
        if not with_ls:
            assert got[0] is got[1]  # one buffer for dx and ddelta
    suffix = "scale_ln" if with_ls else "ln"
    assert aln.LAUNCHES[f"fused_add_{suffix}_fwd"] == 1
    assert aln.LAUNCHES[f"fused_add_{suffix}_bwd"] == 6


@pytest.mark.parametrize("with_ls", [False, True])
def test_add_ln_autograd(device, with_ls):
    """The autograd functions on the card against the plain versions'
    gradients through the same functions on the CPU."""
    rng = np.random.default_rng(2)
    shape = (2, 57, 768)
    args = _add_ln_inputs(rng, shape, torch.bfloat16, device, with_ls)
    gxn = _t(rng, shape, torch.bfloat16, device)
    gy = _t(rng, shape, torch.bfloat16, device)

    def grads(dev):
        leaves = [None if a is None else
                  a.detach().to(dev).requires_grad_(True) for a in args]
        x, delta, ls, scale, bias = leaves
        if with_ls:
            xn, y = aln.fused_add_scale_ln(x, delta, ls, scale, bias, 1e-6)
        else:
            xn, y = aln.fused_add_ln(x, delta, scale, bias, 1e-6)
        torch.autograd.backward((xn, y), (gxn.to(dev), gy.to(dev)))
        return [None if a is None else a.grad.cpu() for a in leaves]

    for name, got, ref in zip(("dx", "ddelta", "dls", "dscale", "dbias"),
                              grads(device), grads("cpu")):
        if ref is None:
            continue
        if name in ("dx", "ddelta"):
            _close(got, ref, torch.bfloat16, name)
        else:
            _sums_close(got, ref, name)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(3, 257, 128), (7, 3072), (5,), (1031,),
                                   (4, 257, 3072)])
def test_gelu_kernel(device, dtype, shape):
    rng = np.random.default_rng(3)
    x = _t(rng, shape, DTYPES[dtype], device, 3.0)
    tg.reset_launch_counts()
    got = tg.gelu_exact_fused(x)
    torch.cuda.synchronize()
    assert tg.LAUNCHES["gelu_exact_fused"] == 1
    assert got.dtype == x.dtype and got.shape == x.shape
    _close(got, tg.gelu_exact_reference(x), x.dtype)
    # a view that starts off a 16-byte boundary takes the scalar path
    if x.numel() > 1:
        flat = x.flatten()[1:]
        _close(tg.gelu_exact_fused(flat), tg.gelu_exact_reference(flat),
               x.dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bh,q_len,kv_len,d", [
    (12, 257, 257, 64), (2, 128, 128, 64), (3, 30, 77, 16), (1, 16, 16, 8),
    (2, 65, 300, 128), (5, 1, 1, 32), (2, 40, 1, 64), (2, 1, 300, 64)])
def test_flash_attention_kernel(device, dtype, bh, q_len, kv_len, d):
    rng = np.random.default_rng(4)
    dt = DTYPES[dtype]
    q = _t(rng, (bh, q_len, d), dt, device)
    k = _t(rng, (bh, kv_len, d), dt, device)
    v = _t(rng, (bh, kv_len, d), dt, device)
    fa.reset_launch_counts()
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == 1 and got.dtype == dt
    _close(got, fa.flash_attention_reference(q, k, v), dt)
    assert torch.equal(got, fa.flash_attention(q, k, v))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bh,q_len,kv_len,d", [(12, 257, 257, 64),
                                               (2, 65, 300, 128)])
def test_flash_attention_kernel_large_scores(device, dtype, bh, q_len,
                                             kv_len, d):
    """q and k of std 4: scores of magnitude 16 and more, rows close to one
    hot, the row maximum growing from key tile to key tile; a running
    maximum or a correction applied wrongly shows at once."""
    rng = np.random.default_rng(6)
    dt = DTYPES[dtype]
    q = _t(rng, (bh, q_len, d), dt, device, 4.0)
    k = _t(rng, (bh, kv_len, d), dt, device, 4.0)
    v = _t(rng, (bh, kv_len, d), dt, device)
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    _close(got, fa.flash_attention_reference(q, k, v), dt)


def test_flash_attention_tensor_core_error_no_larger_than_fma(device):
    """Against the exact function (fp64 on the same bf16 inputs) the
    tensor-core kernel, with P as three bf16 terms, errs no more than the
    fp32-FMA kernel does, up to the order of an fp32 sum."""
    rng = np.random.default_rng(7)
    q, k, v = (_t(rng, (2, 257, 12, 64), torch.bfloat16, device)
               for _ in range(3))
    q64, k64, v64 = (a.double().transpose(1, 2) for a in (q, k, v))
    exact = (torch.softmax(q64 @ k64.transpose(-1, -2) / 8.0, -1)
             @ v64).transpose(1, 2)
    err_tc = (fa.mha_flash(q, k, v).double() - exact).abs().max().item()
    err_fma = (fa.mha_flash_fma(q, k, v).double() - exact).abs().max().item()
    assert err_tc <= err_fma + 1e-6 * max(exact.abs().max().item(), 1.0)


def test_mha_flash_unaligned_views_take_the_scalar_loads(device):
    """k and v as views that start off a 16-byte boundary, with an odd row
    stride: the same tiles through scalar loads."""
    rng = np.random.default_rng(8)
    q = _t(rng, (2, 33, 3, 64), torch.bfloat16, device)
    kv = _t(rng, (2, 50, 3, 65), torch.bfloat16, device)
    k, v = kv[..., 1:], kv[..., :64]
    got = fa.mha_flash(q, k, v)
    torch.cuda.synchronize()
    _close(got, fa.mha_flash_reference(q, k, v), torch.bfloat16)


def test_mha_flash_reads_heads_in_place(device):
    """(batch, seq, heads, d) views of one (batch, seq, 3 * hidden) tensor:
    no copy, the heads read through their strides."""
    rng = np.random.default_rng(5)
    qkv = _t(rng, (2, 257, 3 * 768), torch.bfloat16, device)
    q, k, v = (qkv[..., i * 768:(i + 1) * 768].unflatten(-1, (12, 64))
               for i in range(3))
    got = fa.mha_flash(q, k, v)
    torch.cuda.synchronize()
    assert got.shape == (2, 257, 12, 64) and got.is_contiguous()
    _close(got, fa.mha_flash_reference(q, k, v), torch.bfloat16)
    with pytest.raises(RuntimeError, match="forward only"):
        fa.mha_flash(q.clone().requires_grad_(True), k, v)
    with pytest.raises(ValueError, match="head dim"):
        z = torch.zeros((1, 4, 1, 256), device=device)
        fa.mha_flash(z, z, z)
