"""What surrounds the redesigned LayerScale backward pass of the layer
(csrc/layer_backward.cu::scale_grad_kernel, on the column sum's 16-byte rows
and grid) and kernel 5, the one-pass serving LayerNorm (csrc/row_kernels.cu::
layer_norm_one_pass_rows_kernel, a warp per row), and can run without the
card: the launches the wrappers make, as pure functions of the shape and the
tensors' alignment, read off the C call with the library stood in by a
recorder; numpy emulations of the order in which the kernels add (the two
column sums of the LayerScale pass in the column sum's order, then the split
finishing launch; kernel 5's per-lane chunk sums, then the butterfly of
shuffles) against the plain versions and fp64, with rows shifted by +100
where a fast variance would cancel; and the wrappers on CPU tensors, which
take the plain versions. No JAX, seconds."""
import numpy as np
import pytest
import torch

from hypervla_tpu_torch.ops import dino_layer as dl
from hypervla_tpu_torch.ops import dino_layer_train as dlt
from hypervla_tpu_torch.ops import layer_norm as tln
from test_torch_add_ln_gelu_bwd_redesign import _Recorder
from test_torch_column_gelu_redesign import (
    _fma,
    emulated_colsum_parts,
    emulated_finish,
)
from test_torch_harness import torch_threads  # noqa: F401

EPS = 1e-6
TRAIN_ROWS = 64 * 257
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def _rows(rng, shape, dtype=torch.bfloat16, scale=1.0, shift=0.0):
    return torch.tensor((rng.standard_normal(shape) * scale
                         + shift).astype(np.float32)).to(dtype)


def _unaligned(a):
    """a's values in a view that starts 2 or 4 bytes past a 16-byte
    boundary."""
    flat = torch.empty(a.numel() + 1, dtype=a.dtype)
    odd = flat[1:].view(a.shape).copy_(a)
    assert odd.data_ptr() % 16 != 0
    return odd


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

    for module in (dl, tln):
        monkeypatch.setattr(module, "_route", lambda *t: "cuda")
        monkeypatch.setattr(module, "_stream", lambda: 0)
    monkeypatch.setattr(tln, "_lib", lambda: rec)
    monkeypatch.setattr(tln, "row_lib", lambda: rec)
    monkeypatch.setattr(tln, "finish_sums", finish)
    return rec


# ------------------ the LayerScale pass: its launch ------------------


@pytest.mark.parametrize("rows,cols,grid", [
    # the layer's width at B=64: 3 strips x 176 parts of 8 warps, one wave
    # of four blocks a multiprocessor (528 of 528)
    (TRAIN_ROWS, 768, (3, 176, 8)), (TRAIN_ROWS + 37, 768, (3, 176, 8)),
    (99, 768, (3, 1, 8)), (68, 128, (1, 1, 8)), (1001, 200, (1, 15, 8))])
def test_scale_grad_launches_the_column_sum_grid(recorder, rows, cols, grid):
    assert tuple(dlt.colsum_config(rows, cols)) == grid
    g, y = (torch.zeros((rows, cols), dtype=torch.bfloat16)
            for _ in range(2))
    dlt.reset_launch_counts()
    dy, dls, db = dlt.scale_grad(g, y, torch.ones(cols))
    args = recorder.calls["layer_scale_grad"]
    assert args[5:] == (rows, cols, grid[1], grid[2], 0)
    assert args[3] == dy.data_ptr()
    # one (parts, 2, cols) partial: both column sums of a block in one row
    assert recorder.parts == [(grid[1], 2, cols)]
    assert dls.shape == db.shape == (cols,)
    assert dlt.LAUNCHES["layer_scale_grad"] == 1


@pytest.mark.parametrize("what", ["width 100", "width 3", "unaligned rows",
                                  "unaligned layer_scale"])
def test_scale_grad_refuses_what_its_16_byte_loads_do_not_take(recorder,
                                                               what):
    rng = np.random.default_rng(7)
    cols = {"width 100": 100, "width 3": 3}.get(what, 768)
    g, y = _rows(rng, (9, cols)), _rows(rng, (9, cols))
    ls = torch.ones(cols)
    if what == "unaligned rows":
        y = _unaligned(y)
    if what == "unaligned layer_scale":
        ls = torch.ones(cols + 1)[1:]
    with pytest.raises(ValueError, match="multiples of 8"):
        dlt.scale_grad(g, y, ls)
    assert "layer_scale_grad" not in recorder.calls


# --------------- the LayerScale pass: its order of sums ---------------


def emulated_scale_grad(g, y, ls, config):
    """(dy, dls, db) as csrc/layer_backward.cu::scale_grad_kernel forms
    them: dy = bf16(f32(g) * f32(bf16(ls))) (exact product, one rounding);
    both column sums in the column sum's order on `config` (part p's rows,
    warp w adding rows r0 + w, r0 + w + warps, ... in order, the block's
    warps in warp order), into one (parts, 2, cols) partial that the
    finishing launch adds."""
    gf = g.float()
    dy = (gf * ls.bfloat16().float()).bfloat16()
    part = np.stack([emulated_colsum_parts((gf * y.float()).numpy(), config),
                     emulated_colsum_parts(dy.float().numpy(), config)],
                    axis=1)
    dls, db = emulated_finish(part)
    return dy, dls, db


@pytest.mark.parametrize("rows,cols", [(TRAIN_ROWS, 768),
                                       (TRAIN_ROWS + 37, 768), (99, 768),
                                       (68, 128), (1001, 200)])
def test_scale_grad_sum_order_agrees_with_plain_and_fp64(rows, cols):
    rng = np.random.default_rng(rows + cols)
    g, y = _rows(rng, (rows, cols)), _rows(rng, (rows, cols))
    ls = _rows(rng, (cols,), torch.float32, 0.05, 0.3)
    dy, dls, db = emulated_scale_grad(g, y, ls,
                                      dlt.colsum_config(rows, cols))
    ref_dy, ref_dls, ref_db = dlt.scale_grad_reference(g, y, ls)
    assert torch.equal(dy, ref_dy)  # one rounding of an exact product
    exact = ((g.double() * y.double()).sum(0).numpy(),
             dy.double().sum(0).numpy())
    for name, mine, plain, ex in zip(("dls", "db"), (dls, db),
                                     (ref_dls.numpy(), ref_db.numpy()),
                                     exact):
        for want in (plain, ex):
            bound = 1e-4 * max(float(np.abs(want).max()), 1.0)
            assert float(np.abs(mine - want).max()) <= bound, name


def test_scale_grad_batch_against_its_halves():
    """Each half's sums in its own grid, added: within 1e-4 of the batch's
    (another order of the same terms), as the cuda test holds the kernel."""
    rows, cols = TRAIN_ROWS, 768
    rng = np.random.default_rng(3)
    g, y = _rows(rng, (rows, cols)), _rows(rng, (rows, cols))
    ls = _rows(rng, (cols,), torch.float32, 0.05, 0.3)
    full = emulated_scale_grad(g, y, ls, dlt.colsum_config(rows, cols))
    half = rows // 2
    halves = [emulated_scale_grad(g[sl], y[sl], ls,
                                  dlt.colsum_config(half, cols))
              for sl in (slice(0, half), slice(half, rows))]
    for i in (1, 2):
        want = halves[0][i] + halves[1][i]
        bound = 1e-4 * max(float(np.abs(want).max()), 1.0)
        assert float(np.abs(full[i] - want).max()) <= bound


# ------------------ kernel 5: which kernel, which grid ------------------


@pytest.mark.parametrize("rows,d,plan", [
    # the serving trunk's 25 LayerNorms: 65 blocks of four warps
    (257, 768, (3, 65, 4)), (1, 768, (3, 1, 4)),
    # at most kernel 6's 16 blocks a multiprocessor; the warps walk rows
    (TRAIN_ROWS, 768, (3, 2112, 4)), (31, 1024, (4, 8, 4)),
    (300, 96, (3, 75, 4)), (5, 8, (3, 2, 4)), (40, 776, (4, 10, 4)),
    # the first kernel, a block of 256 threads a row: wider than 1024, no
    # multiple of 8
    (65, 2048, (0, 65, 8)), (68, 100, (0, 68, 8))])
@pytest.mark.parametrize("x_dtype", list(DTYPES))
@pytest.mark.parametrize("vec_dtype", list(DTYPES))
def test_layer_norm_launches_its_plan(recorder, rows, d, plan, x_dtype,
                                      vec_dtype):
    x = torch.zeros((rows, d), dtype=DTYPES[x_dtype])
    vec = torch.ones(d, dtype=DTYPES[vec_dtype])
    assert tuple(tln.layer_norm_plan(rows, d)) == plan
    tln.reset_launch_counts()
    out = tln.layer_norm(x, vec, vec, EPS)
    args = recorder.calls["row_layer_norm"]
    assert args[3] == out.data_ptr()
    assert args[4:6] == (rows, d)
    assert args[7:9] == (int(x_dtype == "fp32"), int(vec_dtype == "fp32"))
    assert args[9:] == (*plan, 0)
    assert tln.LAUNCHES["layer_norm"] == 1


@pytest.mark.parametrize("rows", [1, 257, 1001, TRAIN_ROWS, TRAIN_ROWS + 37])
def test_layer_norm_plan_covers_every_row_once(rows):
    """Warp w of the grid takes rows w, w + (warps of the grid), ...: every
    row once, in one wave of blocks where the rows are few."""
    plan = tln.layer_norm_plan(rows, 768)
    total = plan.blocks * plan.warps
    assert plan.blocks <= dl.SMS * dl.LN_BLOCKS_PER_SM
    taken = np.concatenate([np.arange(w, rows, total) for w in range(total)])
    assert np.array_equal(np.sort(taken), np.arange(rows))


@pytest.mark.parametrize("what", ["x", "scale", "bias"])
def test_layer_norm_sends_unaligned_rows_to_the_first_kernel(recorder, what):
    rows, d = 257, 768
    rng = np.random.default_rng(5)
    x = _rows(rng, (1, rows, d))
    sc, bi = _rows(rng, (d,), scale=0.1, shift=1.0), _rows(rng, (d,))
    if what == "x":
        x = _unaligned(x)
    elif what == "scale":
        sc = _unaligned(sc)
    else:
        bi = _unaligned(bi)
    tln.layer_norm(x, sc, bi, EPS)
    assert recorder.calls["row_layer_norm"][9:12] == (0, rows, 8)


# ------------------ kernel 5: its order of sums ------------------


def _butterfly(lanes):
    """A warp_sum over the last axis (32 lanes) in fp32: at each of the
    five xor-shuffle steps a lane adds its partner's value; every lane ends
    with the same bits."""
    lanes = lanes.astype(np.float32)
    idx = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., idx ^ o]
    assert (lanes == lanes[..., :1]).all()
    return lanes[..., 0]


def emulated_layer_norm(x, scale, bias, eps=EPS, fast_variance=False):
    """csrc/row_kernels.cu::layer_norm_one_pass_rows_kernel in fp32: lane l
    holds chunks l, l + 32, ... of eight values and adds them as eight
    running sums over its chunks, then pairwise; the mean is one butterfly
    of the lanes' sums; the centred
    values stay in registers, their squares are added the same way; y =
    fma(centred * rs, scale, bias), rounded once to x's type. With
    `fast_variance` the statistics are E[x^2] - mean^2 instead (what the
    kernel does not do)."""
    f = np.float32
    rows, d = x.shape
    chunks = d // 8
    ch = -(-chunks // 32)
    v = np.zeros((rows, 32 * ch, 8), f)
    v[:, :chunks] = x.float().numpy().reshape(rows, chunks, 8)
    # [row, chunk index i, lane, value]: chunk 32 i + lane
    v = v.reshape(rows, ch, 32, 8)

    def lane_sums(t):
        # eight running sums over the lane's chunks, then pairwise
        a = np.zeros((rows, 32, 8), f)
        for i in range(ch):
            a = a + t[:, i]
        return (((a[..., 0] + a[..., 1]) + (a[..., 2] + a[..., 3]))
                + ((a[..., 4] + a[..., 5]) + (a[..., 6] + a[..., 7])))

    mu = _butterfly(lane_sums(v)) / f(d)
    if fast_variance:
        var = np.maximum(_butterfly(lane_sums(v * v)) / f(d) - mu * mu, f(0))
        centred = v - mu[:, None, None, None]
    else:
        centred = v - mu[:, None, None, None]
        pad = np.zeros((ch, 32, 8), bool)
        pad.reshape(-1, 8)[chunks:] = True
        centred[:, pad] = 0  # the lanes past the row add nothing
        var = _butterfly(lane_sums(centred * centred)) / f(d)
    rs = (f(1) / np.sqrt(var + f(eps))).astype(f)
    n = (centred * rs[:, None, None, None]).reshape(rows, -1)[:, :d]
    y = _fma(torch.from_numpy(np.ascontiguousarray(n)), scale.float(),
             bias.float())
    return y.to(x.dtype)


def _exact_layer_norm(x, scale, bias, eps=EPS):
    xd = x.double()
    centred = xd - xd.mean(-1, keepdim=True)
    var = (centred * centred).mean(-1, keepdim=True)
    return centred * torch.rsqrt(var + eps) * scale.double() + bias.double()


def _ln_bound(dtype, ref):
    """One ulp of the output's type at the output's scale (2^-7 for bf16;
    1e-5 for fp32, where only the order of the sums differs)."""
    return ((2 ** -7 if dtype == torch.bfloat16 else 1e-5)
            * max(float(ref.abs().max()), 1.0))


@pytest.mark.parametrize("rows,d", [(257, 768), (1, 768), (31, 1024),
                                    (300, 96), (40, 776)])
@pytest.mark.parametrize("x_dtype", list(DTYPES))
@pytest.mark.parametrize("vec_dtype", list(DTYPES))
@pytest.mark.parametrize("shift", [0.0, 100.0])
def test_layer_norm_sum_order_agrees_with_plain_and_fp64(rows, d, x_dtype,
                                                         vec_dtype, shift):
    rng = np.random.default_rng(rows * 7 + d)
    x = _rows(rng, (rows, d), DTYPES[x_dtype], 2.0, shift)
    sc = _rows(rng, (d,), DTYPES[vec_dtype], 0.1, 1.0)
    bi = _rows(rng, (d,), DTYPES[vec_dtype], 0.1)
    got = emulated_layer_norm(x, sc, bi)
    assert got.dtype == x.dtype
    for want in (tln.layer_norm_reference(x, sc, bi, EPS),
                 _exact_layer_norm(x, sc, bi)):
        err = float((got.double() - want.double()).abs().max())
        assert err <= _ln_bound(x.dtype, want), err


def test_layer_norm_shift_would_break_a_fast_variance():
    """At +100 in fp32 the fast variance E[x^2] - mean^2 cancels: the same
    emulation with it lands far outside the bound the two-pass one keeps,
    so the shifted cases above see which variance the kernel takes."""
    rng = np.random.default_rng(11)
    x = _rows(rng, (257, 768), torch.float32, 0.5, 100.0)
    sc, bi = _rows(rng, (768,), torch.float32, 0.1, 1.0), torch.zeros(768)
    want = _exact_layer_norm(x, sc, bi)
    fast = emulated_layer_norm(x, sc, bi, fast_variance=True)
    two_pass = emulated_layer_norm(x, sc, bi)
    bound = _ln_bound(torch.float32, want)
    assert float((two_pass.double() - want).abs().max()) <= bound
    assert float((fast.double() - want).abs().max()) > 100 * bound


# -------------------- the wrappers on CPU tensors --------------------


@pytest.mark.parametrize("cols", [768, 100])
def test_scale_grad_on_the_cpu_is_the_plain_version(cols):
    """Any width on the CPU: the width rule is the kernel's."""
    rng = np.random.default_rng(cols)
    g, y = _rows(rng, (37, cols)), _rows(rng, (37, cols))
    ls = _rows(rng, (cols,), torch.float32, 0.05, 0.3)
    dlt.reset_launch_counts()
    assert all(torch.equal(a, b) for a, b in zip(
        dlt.scale_grad(g, y, ls), dlt.scale_grad_reference(g, y, ls)))
    assert dlt.LAUNCHES["layer_scale_grad"] == 0


@pytest.mark.parametrize("x_dtype", list(DTYPES))
@pytest.mark.parametrize("vec_dtype", list(DTYPES))
def test_layer_norm_on_the_cpu_is_the_plain_version(x_dtype, vec_dtype):
    rng = np.random.default_rng(2)
    x = _rows(rng, (1, 257, 768), DTYPES[x_dtype], 2.0, 100.0)
    sc = _rows(rng, (768,), DTYPES[vec_dtype], 0.1, 1.0)
    bi = _rows(rng, (768,), DTYPES[vec_dtype], 0.1)
    tln.reset_launch_counts()
    assert torch.equal(tln.layer_norm(x, sc, bi, EPS),
                       tln.layer_norm_reference(x, sc, bi, EPS))
    assert tln.LAUNCHES["layer_norm"] == 0
