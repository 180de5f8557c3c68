"""What surrounds the redesigned residual add + LayerNorm (kernels 7 and 8,
a warp per row) and the layer backward's GELU pass (the column sum's
16-byte rows, the erfc fit), and can run without the card: the launches the
wrappers make (kernel 6's row plans; the column sum's grid), as pure
functions of the shape, read off the C call with the library stood in by a
recorder; numpy emulations of the order in which the kernels add their
column sums (csrc/row_kernels.cu::add_ln_bwd_rows_kernel: a warp's rows in
turn, the block's warps in warp order, then the split finishing launch;
csrc/layer_backward.cu::gelu_bwd_kernel: the column sum's order) against
the plain versions and fp64; the GELU backward's fp32 form
(csrc/gelu_fit.cuh) over every finite bf16 input against the plain
version; and the wrappers on CPU tensors, which take the plain versions.
No JAX, seconds."""
import math

import numpy as np
import pytest
import torch

from hypervla_tpu_torch.ops import add_layer_norm as aln
from hypervla_tpu_torch.ops import dino_layer as dl
from hypervla_tpu_torch.ops import dino_layer_train as dlt
from hypervla_tpu_torch.ops import layer_norm as tln
from test_torch_column_gelu_redesign import (
    _every_finite_bf16,
    _fma,
    bf16_ulps,
    emulated_colsum,
    emulated_erfc_neg,
    emulated_finish,
    emulated_gelu,
)
from test_torch_harness import torch_threads  # noqa: F401

EPS = 1e-6
TRAIN_ROWS = 64 * 257


def _bf16(rng, shape, scale=1.0, shift=0.0):
    return torch.tensor((rng.standard_normal(shape) * scale
                         + shift).astype(np.float32)).bfloat16()


def _fp32(rng, shape, scale=1.0, shift=0.0):
    return torch.tensor((rng.standard_normal(shape) * scale
                         + shift).astype(np.float32))


def _add_ln_inputs(rows, d, seed):
    """(x_new, g_y, g_xnew, delta, ls, scale): bf16 rows, fp32 vectors."""
    rng = np.random.default_rng(seed)
    xn = _bf16(rng, (rows, d), 2.0, 0.5)
    gy, gxn, delta = (_bf16(rng, (rows, d)) for _ in range(3))
    return (xn, gy, gxn, delta, _fp32(rng, (d,), 0.02, 0.1),
            _fp32(rng, (d,), 0.1, 1.0))


# ------------------------ the launches, from the shape ------------------------


class _Recorder:
    """Stands in for the built libraries: records each C call's arguments
    and returns 0 (no error)."""

    def __init__(self):
        self.calls = {}

    def row_max_width(self):
        return 2048

    def __getattr__(self, name):
        def call(*args):
            self.calls[name] = args
            return 0
        return call


@pytest.fixture
def recorder(monkeypatch):
    """The wrappers' launches on CPU tensors, as they would be made for CUDA
    tensors of the same shape and alignment; the finishing launch records
    the partials' shape."""
    rec = _Recorder()
    rec.parts = []

    def finish(part):
        rec.parts.append(tuple(part.shape))
        return torch.zeros(part.shape[1:])

    for module in (aln, dl):
        monkeypatch.setattr(module, "_route", lambda *t: "cuda")
        monkeypatch.setattr(module, "_stream", lambda: 0)
    monkeypatch.setattr(aln, "row_lib", lambda: rec)
    monkeypatch.setattr(aln, "finish_sums", finish)
    monkeypatch.setattr(tln, "_lib", lambda: rec)
    monkeypatch.setattr(tln, "finish_sums", finish)
    return rec


@pytest.mark.parametrize("rows,d,chunks", [
    (TRAIN_ROWS, 768, 3), (TRAIN_ROWS + 37, 768, 3), (99, 768, 3),
    (1001, 1024, 4), (300, 96, 3),
    # the first kernels: no multiple of 8, wider than 1024
    (68, 100, 0), (65, 2048, 0)])
@pytest.mark.parametrize("with_ls", [False, True])
def test_add_ln_wrappers_launch_kernel_6s_plans(recorder, rows, d, chunks,
                                                with_ls):
    xn, gy, gxn, delta = (torch.zeros((rows, d), dtype=torch.bfloat16)
                          for _ in range(4))
    scale = torch.ones(d)
    ls = scale if with_ls else None
    fwd = dl.layer_norm_plan(rows, d)
    bwd = tln.layer_norm_bwd_plan(rows, d)
    assert fwd.chunks == bwd.chunks == chunks
    aln.add_ln_fwd(xn, delta, ls, scale, scale, EPS)
    args = recorder.calls["row_add_ln_fwd"]
    assert args[7:9] == (rows, d) and args[-4:-1] == tuple(fwd)
    aln.add_ln_bwd(gy, gxn, xn, delta, ls, scale, EPS)
    args = recorder.calls["row_add_ln_bwd"]
    assert args[9:12] == (rows, d, tln.ROWS_PER_BLOCK)
    assert args[-4:-1] == tuple(bwd)
    # one fp32 partial of each column sum per block of the plan
    assert recorder.parts == [(bwd.blocks, 3 if with_ls else 2, d)]


@pytest.mark.parametrize("rows,plan", [
    # the training shape: one wave of four blocks of two warps a
    # multiprocessor, 528 partials (the first kernel walked 32 rows a
    # block: 514)
    (TRAIN_ROWS, (3, 528, 2)), (TRAIN_ROWS + 37, (3, 528, 2)),
    # fewer rows than multiprocessors: a warp a block, a row a warp
    (99, (3, 99, 1))])
def test_add_ln_backward_partials_of_the_shapes(rows, plan):
    got = tln.layer_norm_bwd_plan(rows, 768)
    assert got == plan
    assert got.blocks <= dl.SMS * tln.LN_BWD_BLOCKS_PER_SM  # one wave
    total = got.blocks * got.warps
    taken = np.concatenate([np.arange(w, rows, total) for w in range(total)])
    assert np.array_equal(np.sort(taken), np.arange(rows))


def test_add_ln_wrappers_send_unaligned_rows_to_the_first_kernels(recorder):
    rows, d = 40, 768
    xn, gy, gxn, delta, ls, scale = _add_ln_inputs(rows, d, 4)
    flat = torch.empty(rows * d + 1, dtype=torch.bfloat16)
    odd = flat[1:].view(rows, d).copy_(delta)
    assert odd.data_ptr() % 16 != 0
    aln.add_ln_fwd(xn, odd, ls, scale, scale, EPS)
    assert recorder.calls["row_add_ln_fwd"][-4:-1] == (0, rows, 8)
    aln.add_ln_bwd(gy, gxn, xn, odd, ls, scale, EPS)
    assert recorder.calls["row_add_ln_bwd"][-4:-1] == (
        0, -(-rows // tln.ROWS_PER_BLOCK), 8)


@pytest.mark.parametrize("rows,cols,grid", [
    # fc1's width at B=64: 12 strips x 44 parts of 8 warps, one wave of four
    # blocks a multiprocessor (528 of 528)
    (TRAIN_ROWS, 3072, (12, 44, 8)), (TRAIN_ROWS + 37, 3072, (12, 44, 8)),
    (99, 3072, (12, 1, 8)), (1028, 768, (3, 16, 8)), (68, 128, (1, 1, 8))])
def test_gelu_bwd_launches_the_column_sum_grid(recorder, rows, cols, grid):
    assert tuple(dlt.colsum_config(rows, cols)) == grid
    hc, dh = (torch.zeros((rows, cols), dtype=torch.bfloat16)
              for _ in range(2))
    dlt.reset_launch_counts()
    dlt.gelu_bwd(hc, dh)
    args = recorder.calls["layer_gelu_bwd"]
    assert args[5:] == (rows, cols, grid[1], grid[2], 0)
    assert recorder.parts == [(grid[1], cols)]
    assert dlt.LAUNCHES["layer_gelu_bwd"] == 1


@pytest.mark.parametrize("cols", [100, 3])
def test_gelu_bwd_refuses_widths_off_the_16_byte_rows(recorder, cols):
    rng = np.random.default_rng(cols)
    hc, dh = _bf16(rng, (9, cols)), _bf16(rng, (9, cols))
    with pytest.raises(ValueError, match="multiples of 8"):
        dlt.gelu_bwd(hc, dh)
    assert "layer_gelu_bwd" not in recorder.calls


# ------------------ the residual boundary's order of sums ------------------


def emulated_add_ln_bwd_sums(xn, gy, gxn, delta, ls, scale, plan):
    """(dscale, dbias, dls) as csrc/row_kernels.cu::add_ln_bwd_rows_kernel
    adds them, in fp32: warp w of the grid adds g_y * xhat, g_y and dx_new *
    delta of rows w, w + (warps of the grid), ... in that order (a lane's
    8 columns side by side, so every column the same); a block adds its
    warps' sums in warp order and leaves one partial; the finishing launch
    adds the partials in its fixed order. The row statistics and dx_new in
    fp32 as the kernel forms them."""
    f = np.float32
    rows, d = xn.shape
    sc = scale.numpy()
    total = plan.blocks * plan.warps
    mine = np.zeros((total, 3, d), f)
    for start in range(0, rows, total):
        n = min(total, rows - start)
        x, g, h, dv = (t[start:start + n].float().numpy()
                       for t in (xn, gy, gxn, delta))
        mu = x.sum(-1, dtype=f, keepdims=True) / f(d)
        var = np.maximum((x * x).sum(-1, dtype=f, keepdims=True) / f(d)
                         - mu * mu, f(0))
        rs = f(1) / np.sqrt(var + f(EPS))
        xhat = (x - mu) * rs
        gs = g * sc
        m1 = gs.sum(-1, dtype=f, keepdims=True) / f(d)
        m2 = (gs * xhat).sum(-1, dtype=f, keepdims=True) / f(d)
        dx = rs * (gs - m1 - xhat * m2) + h
        # row start + i is warp i's
        mine[:n] += np.stack([g * xhat, g, dx * dv], axis=1)
    per_warp = mine.reshape(plan.blocks, plan.warps, 3, d)
    part = per_warp[:, 0].copy()
    for w in range(1, plan.warps):
        part += per_warp[:, w]
    return emulated_finish(part)


def _exact_add_ln_bwd_sums(xn, gy, gxn, delta, scale):
    x, g, h, dv = (t.double() for t in (xn, gy, gxn, delta))
    mu = x.mean(-1, keepdim=True)
    var = ((x * x).mean(-1, keepdim=True) - mu * mu).clamp(min=0.0)
    rs = torch.rsqrt(var + EPS)
    xhat = (x - mu) * rs
    gs = g * scale.double()
    dx = rs * (gs - gs.mean(-1, keepdim=True)
               - xhat * (gs * xhat).mean(-1, keepdim=True)) + h
    return [s.numpy() for s in ((g * xhat).sum(0), g.sum(0),
                                (dx * dv).sum(0))]


@pytest.mark.parametrize("rows,d", [(TRAIN_ROWS, 768), (TRAIN_ROWS + 37, 768),
                                    (1001, 768), (99, 768), (700, 1024),
                                    (2100, 96)])
def test_add_ln_backward_sum_order_agrees_with_plain_and_fp64(rows, d):
    xn, gy, gxn, delta, ls, scale = _add_ln_inputs(rows, d, rows * 3 + d)
    plan = tln.layer_norm_bwd_plan(rows, d)
    got = emulated_add_ln_bwd_sums(xn, gy, gxn, delta, ls, scale, plan)
    _, _, dls, dscale, dbias = aln.add_ln_bwd_reference(gy, gxn, xn, delta,
                                                        ls, scale, EPS)
    plain = [s.numpy() for s in (dscale, dbias, dls)]
    exact = _exact_add_ln_bwd_sums(xn, gy, gxn, delta, scale)
    for name, mine, ref, ex in zip(("dscale", "dbias", "dls"), got, plain,
                                   exact):
        for want in (ref, ex):
            bound = 1e-4 * max(float(np.abs(want).max()), 1.0)
            assert float(np.abs(mine - want).max()) <= bound, name


@pytest.mark.parametrize("blocks,warps", [(1, 1), (7, 8), (528, 2)])
def test_add_ln_backward_sum_order_under_any_grid(blocks, warps):
    rows, d = 900, 128
    xn, gy, gxn, delta, ls, scale = _add_ln_inputs(rows, d, 5)
    got = emulated_add_ln_bwd_sums(xn, gy, gxn, delta, ls, scale,
                                   dl.RowPlan(3, blocks, warps))
    _, _, dls, dscale, dbias = aln.add_ln_bwd_reference(gy, gxn, xn, delta,
                                                        ls, scale, EPS)
    for mine, ref in zip(got, (dscale, dbias, dls)):
        ref = ref.numpy()
        assert np.abs(mine - ref).max() <= 1e-4 * max(np.abs(ref).max(), 1.0)


# --------------------- the GELU backward's fp32 form ---------------------


def emulated_gelu_bwd(xf, rcp_err=0.0, exp_err=0.0):
    """(h, gelu') in fp32 as csrc/layer_backward.cu::gelu_bwd_kernel forms
    them: e = erfc(-x / sqrt 2) by the fit, h = 0.5 x e, gelu' = 0.5 e + x
    pdf (one FMA), pdf = exp2(x x (-0.5 / ln 2)) / sqrt(2 pi); rcp.approx
    and ex2.approx off by (1 + rcp_err), (1 + exp_err)."""
    f = np.float32
    e = emulated_erfc_neg(xf, rcp_err, exp_err)
    pdf = f(1 / math.sqrt(2 * math.pi)) * (
        torch.exp2((xf * xf) * f(-0.5 / math.log(2))) * f(1 + exp_err))
    return 0.5 * xf * e, _fma(xf, pdf, 0.5 * e)


def _plain_h_and_dgelu(x):
    """The plain version's h and bf16(gelu'(x)): its dhc with dh = 1."""
    h, dgelu, _ = dlt.gelu_bwd_reference(x[:, None], torch.ones_like(
        x[:, None]))
    return h[:, 0], dgelu[:, 0]


@pytest.mark.parametrize("rcp_err,exp_err", [(0.0, 0.0), (2 ** -21, 2 ** -21),
                                             (-2 ** -21, -2 ** -21),
                                             (2 ** -21, -2 ** -21),
                                             (-2 ** -21, 2 ** -21)])
def test_gelu_bwd_fit_form_at_every_bf16_input(rcp_err, exp_err):
    """Every finite bf16 input, the fast reciprocal and exp2 off by several
    times their documented relative error either way: h and bf16(gelu')
    within one bf16 ulp of the plain version, except below x = -4, where
    the plain version's 1 + erf(x / sqrt 2) cancels (its h is 0 below x ~
    -5.44); there within 1e-6 absolute. With exact rcp and ex2 that is 200
    inputs for h and 141 for gelu' (all in [-13.5, -4.4]). Near the zero of
    gelu' (x ~ -0.7518), where cdf and x pdf cancel, every input is within
    one ulp."""
    x = _every_finite_bf16()
    xf = x.float()
    h, dgelu = emulated_gelu_bwd(xf, rcp_err, exp_err)
    for name, got, ref in zip(("h", "gelu'"), (h, dgelu),
                              _plain_h_and_dgelu(x)):
        got = got.bfloat16().float()
        ulps = bf16_ulps(got, ref.float())
        over = ulps > 1
        assert bool((xf[over] < -4).all()), name
        assert float((got - ref.float()).abs()[over].max()) <= 1e-6, name
        assert 100 <= int(over.sum()) <= 256, name
        near_zero = (xf > -0.9) & (xf < -0.6)
        assert float(ulps[near_zero].max()) <= 1.0, name
    # the fit is the accurate one: within one ulp of fp64 rounded, everywhere
    xd = xf.double()
    cdf = 0.5 * torch.special.erfc(-xd / math.sqrt(2))
    exact = (xd * cdf, cdf + xd * torch.exp(-0.5 * xd * xd)
             / math.sqrt(2 * math.pi))
    for got, ref in zip((h, dgelu), exact):
        ulps = bf16_ulps(got.bfloat16().float(), ref.float().bfloat16().float())
        assert float(ulps.max()) <= 1.0


def test_gelu_bwd_h_is_kernel_9s_forward():
    """The backward recomputes h with kernel 9's arithmetic, so its h is the
    fused GELU's bit for bit; against the plain backward's erf form (the
    form the layer's forward epilogue takes, erff) it differs only where
    that form cancels."""
    x = _every_finite_bf16()
    xf = x.float()
    h, _ = emulated_gelu_bwd(xf)
    assert torch.equal(h, emulated_gelu(xf))
    plain_h, _ = _plain_h_and_dgelu(x)
    differ = h.bfloat16() != plain_h
    assert bool((xf[differ] < -4).all()) and int(differ.sum()) <= 256


@pytest.mark.parametrize("rows,cols", [(TRAIN_ROWS, 768),
                                       (TRAIN_ROWS + 37, 768), (99, 3072),
                                       (1001, 200), (68, 128)])
def test_gelu_bwd_sum_order_agrees_with_plain_and_fp64(rows, cols):
    """db1 as the kernel adds it (the column sum's order on its grid) over
    the kernel's dhc, against the plain version and the same terms in
    fp64."""
    rng = np.random.default_rng(rows + cols)
    hc, dh = _bf16(rng, (rows, cols), 1.5), _bf16(rng, (rows, cols), 0.1)
    _, dgelu = emulated_gelu_bwd(hc.float())
    dhc = dgelu.bfloat16() * dh
    got = emulated_colsum(dhc.float().numpy(), dlt.colsum_config(rows, cols))
    plain = dlt.gelu_bwd_reference(hc, dh)[2].numpy()
    exact = dhc.double().sum(0).numpy()
    for want in (plain, exact):
        bound = 1e-4 * max(float(np.abs(want).max()), 1.0)
        assert float(np.abs(got - want).max()) <= bound


# ---------------------- the wrappers on CPU tensors ----------------------


@pytest.mark.parametrize("with_ls", [False, True])
def test_add_ln_on_the_cpu_is_the_plain_version(with_ls):
    xn, gy, gxn, delta, ls, scale = _add_ln_inputs(33, 768, 2)
    ls = ls if with_ls else None
    aln.reset_launch_counts()
    for got, ref in ((aln.add_ln_fwd(xn, delta, ls, scale, scale, EPS),
                      aln.add_ln_fwd_reference(xn, delta, ls, scale, scale,
                                               EPS)),
                     (aln.add_ln_bwd(gy, gxn, xn, delta, ls, scale, EPS),
                      aln.add_ln_bwd_reference(gy, gxn, xn, delta, ls, scale,
                                               EPS))):
        assert all(a is b is None or torch.equal(a, b)
                   for a, b in zip(got, ref))
    assert not any(aln.LAUNCHES.values())


@pytest.mark.parametrize("cols", [3072, 100])
def test_gelu_bwd_on_the_cpu_is_the_plain_version(cols):
    """Any width on the CPU: the width rule is the kernel's."""
    rng = np.random.default_rng(cols)
    hc, dh = _bf16(rng, (37, cols), 1.5), _bf16(rng, (37, cols), 0.1)
    dlt.reset_launch_counts()
    assert all(torch.equal(a, b) for a, b in zip(
        dlt.gelu_bwd(hc, dh), dlt.gelu_bwd_reference(hc, dh)))
    assert dlt.LAUNCHES["layer_gelu_bwd"] == 0
