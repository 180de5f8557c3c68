"""What surrounds the serving trunk's tensor-core attention and the
warp-per-row LayerNorm kernels and can run without the card: which widths
and row counts take the warp-per-row kernels and with what grid, the
attention's grid and the longest sequence it takes, as pure functions of
the shape; numpy emulations of the orders in which the
kernels add (the LayerNorm backward's warp / block / finishing launch; the
attention's key warps) against the plain versions; the check that holds the
attention kernel to its plain version where a score lies at a bf16 rounding
midpoint; and the wrappers on CPU tensors, which take the plain versions."""
import numpy as np
import pytest
import torch

from hypervla_tpu_torch.ops import dino_layer as dl
from hypervla_tpu_torch.ops import layer_norm as tln
from test_torch_column_gelu_redesign import emulated_finish
from test_torch_harness import torch_threads  # noqa: F401

# ------------------ which rows take the warp-per-row kernels ------------------


@pytest.mark.parametrize("d,chunks", [
    (768, 3), (8, 3), (64, 3), (128, 3), (384, 3), (760, 3), (776, 4),
    (1024, 4), (1032, 0), (2048, 0), (100, 0), (4, 0), (7, 0), (771, 0)])
def test_row_chunks_by_width(d, chunks):
    """A lane holds three chunks of eight values up to width 768, four up
    to 1024; other widths (no multiple of 8, or wider) keep the first
    kernels."""
    assert dl.row_chunks(d) == chunks
    if chunks:
        assert d % 8 == 0 and d // 8 <= 32 * chunks


def test_row_chunks_wants_aligned_tensors():
    x = torch.zeros(2 * 768 + 8, dtype=torch.bfloat16)
    aligned, odd = x[:2 * 768].view(2, 768), x[1:2 * 768 + 1].view(2, 768)
    assert aligned.data_ptr() % 16 == 0 and odd.data_ptr() % 16 != 0
    assert dl.row_chunks(768, aligned) == 3
    assert dl.row_chunks(768, aligned, odd) == 0
    assert dl.layer_norm_plan(2, 768, odd).chunks == 0
    assert tln.layer_norm_bwd_plan(2, 768, aligned, odd).chunks == 0


@pytest.mark.parametrize("rows,forward,backward", [
    # the training shape: four forward waves of 528 blocks, one backward
    # wave of four blocks of two warps a multiprocessor (528 partial sums)
    (64 * 257, (3, 2112, 4), (3, 528, 2)),
    # the serving trunk: one warp a block, so that every multiprocessor
    # has a block
    (257, (3, 257, 1), (3, 257, 1)),
    (1, (3, 1, 1), (3, 1, 1)), (131, (3, 131, 1), (3, 131, 1)),
    (300, (3, 150, 2), (3, 150, 2)), (1001, (3, 251, 4), (3, 501, 2)),
    (3000, (3, 750, 4), (3, 528, 2))])
def test_layer_norm_plans_of_the_shapes(rows, forward, backward):
    assert dl.layer_norm_plan(rows, 768) == forward
    assert tln.layer_norm_bwd_plan(rows, 768) == backward


@pytest.mark.parametrize("rows", [1, 31, 257, 1001, 5000, 64 * 257, 70000])
@pytest.mark.parametrize("d", [96, 768, 1024])
def test_plans_fit_the_kernels_and_cover_the_rows(rows, d):
    for plan, per_sm, warps in (
            (dl.layer_norm_plan(rows, d), dl.LN_BLOCKS_PER_SM, dl.LN_WARPS),
            (tln.layer_norm_bwd_plan(rows, d), tln.LN_BWD_BLOCKS_PER_SM,
             tln.LN_BWD_WARPS)):
        assert plan.chunks == (3 if d <= 768 else 4)
        assert 1 <= plan.warps <= warps and 1 <= plan.blocks <= dl.SMS * per_sm
        total = plan.blocks * plan.warps
        # no warp of the grid is without a row unless the rows are fewer
        # than one block's warps, and the shape alone decides
        assert total < rows + plan.warps
        assert plan == type(plan)(*plan)
        # warp w walks rows w, w + total, ...: every row once
        taken = np.concatenate([np.arange(w, rows, total)
                                for w in range(total)])
        assert np.array_equal(np.sort(taken), np.arange(rows))


@pytest.mark.parametrize("rows,d", [(300, 2048), (68, 100)])
def test_other_widths_keep_the_first_kernels(rows, d):
    assert dl.layer_norm_plan(rows, d) == (0, rows, 8)
    assert tln.layer_norm_bwd_plan(rows, d) == (
        0, -(-rows // tln.ROWS_PER_BLOCK), 8)


# ----------------- the LayerNorm backward's order of sums -----------------


def _bwd_inputs(rows, d, seed, shift=0.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, d)) * 0.5 + shift).astype(np.float32)
    g = rng.standard_normal((rows, d)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    return x, g, scale


def _emulated_column_sums(x, g, eps, plan):
    """dscale, dbias as csrc/layer_backward.cu adds them, in fp32: warp w of
    the grid adds g * xhat and g of rows w, w + (warps of the grid), ... in
    that order; a block adds its warps' sums in warp order and leaves one
    partial; the finishing launch adds the partials in its fixed order."""
    f = np.float32
    rows, d = x.shape
    mu = x.sum(-1, dtype=f, keepdims=True) / f(d)
    var = np.maximum((x * x).sum(-1, dtype=f, keepdims=True) / f(d) - mu * mu,
                     f(0))
    xhat = (x - mu) * (f(1) / np.sqrt(var + f(eps)))
    terms = np.stack([g * xhat, g], axis=1)            # (rows, 2, d)
    total = plan.blocks * plan.warps
    part = np.zeros((plan.blocks, 2, d), f)
    for block in range(plan.blocks):
        for warp in range(plan.warps):
            mine = np.zeros((2, d), f)
            for r in range(block * plan.warps + warp, rows, total):
                mine += terms[r]
            part[block] = mine if warp == 0 else part[block] + mine
    out = emulated_finish(part)
    return out[0], out[1]


@pytest.mark.parametrize("rows,d,shift", [(257, 768, 0.0), (1001, 768, 1.0),
                                          (2100, 96, 0.0), (700, 1024, 3.0)])
def test_backward_sum_order_agrees_with_the_plain_version(rows, d, shift):
    x, g, scale = _bwd_inputs(rows, d, rows + d, shift)
    plan = tln.layer_norm_bwd_plan(rows, d)
    assert plan.chunks > 0
    got = _emulated_column_sums(x, g, 1e-6, plan)
    again = _emulated_column_sums(x, g, 1e-6, plan)
    _, dscale, dbias = tln.layer_norm_bwd_rows_reference(
        torch.tensor(x), torch.tensor(g), torch.tensor(scale), 1e-6)
    for mine, repeat, ref in zip(got, again, (dscale, dbias)):
        assert np.array_equal(mine, repeat)  # a fixed order: the same bits
        ref = ref.numpy()
        assert np.abs(mine - ref).max() <= 1e-4 * max(np.abs(ref).max(), 1.0)


def test_backward_sums_of_a_batch_are_its_halves_in_another_order():
    """The rows are dealt to the warps in turn, so a batch's sums are not
    bit for bit the sum of its halves': they agree within 1e-4."""
    rows, d = 2056, 768
    x, g, _ = _bwd_inputs(rows, d, 11, 1.0)
    full = _emulated_column_sums(x, g, 1e-6, tln.layer_norm_bwd_plan(rows, d))
    half = rows // 2
    plan = tln.layer_norm_bwd_plan(half, d)
    lo = _emulated_column_sums(x[:half], g[:half], 1e-6, plan)
    hi = _emulated_column_sums(x[half:], g[half:], 1e-6, plan)
    for a, b, c in zip(full, lo, hi):
        assert np.abs(a - (b + c)).max() <= 1e-4 * max(np.abs(a).max(), 1.0)


@pytest.mark.parametrize("blocks,warps", [(1, 1), (7, 8), (528, 2)])
def test_backward_sum_order_under_any_grid(blocks, warps):
    rows, d = 900, 128
    x, g, scale = _bwd_inputs(rows, d, 5)
    got = _emulated_column_sums(x, g, 1e-6, dl.RowPlan(3, blocks, warps))
    _, dscale, dbias = tln.layer_norm_bwd_rows_reference(
        torch.tensor(x), torch.tensor(g), torch.tensor(scale), 1e-6)
    for mine, ref in zip(got, (dscale.numpy(), dbias.numpy())):
        assert np.abs(mine - ref).max() <= 1e-4 * max(np.abs(ref).max(), 1.0)


# ---------------------- the wrappers on CPU tensors ----------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layer_norm_wrappers_on_the_cpu_are_the_plain_versions(dtype):
    x, g, scale = (torch.tensor(a) for a in _bwd_inputs(33, 768, 3, 0.5))
    x, g, bias = x.to(dtype), g.to(dtype), scale - 1.0
    dl.reset_launch_counts()
    tln.reset_launch_counts()
    assert torch.equal(dl.layer_norm_rows(x, scale, bias, 1e-6),
                       dl.layer_norm_rows_reference(x, scale, bias, 1e-6))
    got = tln.layer_norm_bwd_rows(x, g, scale, 1e-6)
    ref = tln.layer_norm_bwd_rows_reference(x, g, scale, 1e-6)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert dl.LAUNCHES["dino_layer_norm"] == 0
    assert tln.LAUNCHES["layer_norm_bwd_rows"] == 0


@pytest.mark.parametrize("seq,hidden", [(19, 128), (1, 64), (321, 64)])
def test_attention_on_the_cpu_is_the_plain_version(seq, hidden):
    """Whatever the length: the limit is the kernel's, not the function's."""
    rng = np.random.default_rng(8)
    qkv = torch.tensor(rng.standard_normal((seq, 3 * hidden)).astype(
        np.float32)).bfloat16()
    dl.reset_launch_counts()
    assert torch.equal(dl.attention(qkv), dl.attention_reference(qkv))
    assert dl.LAUNCHES["dino_attention"] == 0


# ------------- a score at the midpoint of two bf16 neighbours -------------


def _qkv_with_a_leading_midpoint_score(cancelling=False):
    """One head; query 0 against key 3 scores exactly 16 + 2^-4, the
    midpoint of the bf16 neighbours 16 and 16.125, and shares the lead of
    its row with key 7 (16 exactly), whose value is the opposite. With
    `cancelling`, 257 tokens and two large terms a key that cancel: the
    error bound of a sum then exceeds the spacing of the row's small
    scores, dozens of which are ambiguous without mattering."""
    rng = np.random.default_rng(21)
    qkv = rng.standard_normal((257 if cancelling else 40, 192)).astype(
        np.float32)
    qkv[0, :64] = 0.0
    qkv[0, :2] = 8.0                       # q * 0.125 = (1, 1, 0, ...)
    if cancelling:
        qkv[0, 2:4] = 8.0
        qkv[:, 66] = 64.0 * np.round(4 * qkv[:, 66]) / 4
        qkv[:, 67] = -qkv[:, 66]
    qkv[3, 64:66] = (16.0, 2.0 ** -4)      # k_3: the score 16.0625
    qkv[7, 64:66] = (16.0, 0.0)            # k_7: the score 16
    qkv[3, 128:], qkv[7, 128:] = 2.0, -2.0
    return torch.tensor(qkv).bfloat16()


def _attention_with_score(qkv, row, key, value):
    """attention_reference of one head with the rounded score (row, key)
    replaced by `value`."""
    q = (qkv[:, :64] * 0.125).float()
    scores = (q @ qkv[:, 64:128].float().t()).bfloat16().float()
    scores[row, key] = value
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    probs = (e / e.sum(-1, keepdim=True)).bfloat16()
    return (probs.float() @ qkv[:, 128:].float()).bfloat16()


@pytest.mark.parametrize("cancelling", [False, True])
def test_a_midpoint_score_rounded_either_way_is_explained(cancelling):
    qkv = _qkv_with_a_leading_midpoint_score(cancelling)
    ref = dl.attention_reference(qkv)
    bound = 2 ** -7 * max(float(ref.float().abs().max()), 1.0)
    assert dl.attention_unexplained_rows(qkv, ref, bound) == (0, 0)
    # round-to-even gave 16; the other neighbour moves the row past one ulp
    assert torch.equal(_attention_with_score(qkv, 0, 3, 16.0), ref)
    other = _attention_with_score(qkv, 0, 3, 16.125)
    assert float((other.float() - ref.float()).abs().max()) > bound
    assert dl.attention_unexplained_rows(qkv, other, bound) == (1, 0)


@pytest.mark.parametrize("how", ["two ulps of the score", "another row",
                                 "a wrong output"])
def test_what_no_rounding_explains_is_counted(how):
    qkv = _qkv_with_a_leading_midpoint_score()
    ref = dl.attention_reference(qkv)
    bound = 2 ** -7 * max(float(ref.float().abs().max()), 1.0)
    if how == "two ulps of the score":
        got = _attention_with_score(qkv, 0, 3, 16.25)
    elif how == "another row":
        # row 5 has no score near a midpoint that leads it
        got = _attention_with_score(qkv, 5, 3, 16.125)
    else:
        got = ref.clone()
        got[0] += 0.25
    assert float((got.float() - ref.float()).abs().max()) > bound
    over, unexplained = dl.attention_unexplained_rows(qkv, got, bound)
    assert over >= 1 and unexplained == over


def test_scores_in_another_order_leave_nothing_unexplained():
    """The scores summed in fp64 and rounded once flip a few of 800,000
    against the fp32 product's: whatever rows that moves are explained."""
    rng = np.random.default_rng(7)
    qkv = torch.tensor((rng.standard_normal((257, 3 * 768)) * 2.0).astype(
        np.float32)).bfloat16()
    seq, hidden, heads = 257, 768, 12

    def split(t):
        return t.reshape(seq, heads, 64).transpose(0, 1)

    q = split(qkv[:, :hidden] * 0.125).double()
    exact = q @ split(qkv[:, hidden:2 * hidden]).double().transpose(1, 2)
    scores = exact.float().bfloat16().float()
    plain = (q.float() @ split(qkv[:, hidden:2 * hidden]).float().transpose(
        1, 2)).bfloat16().float()
    assert 0 < int((scores != plain).sum()) < 200
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    probs = (e / e.sum(-1, keepdim=True)).bfloat16()
    got = (probs.float() @ split(qkv[:, 2 * hidden:]).float()).bfloat16()
    got = got.transpose(0, 1).reshape(seq, hidden)
    ref = dl.attention_reference(qkv)
    bound = 2 ** -7 * max(float(ref.float().abs().max()), 1.0)
    assert dl.attention_unexplained_rows(qkv, got, bound)[1] == 0


# ------------------------- the attention's launch -------------------------


@pytest.mark.parametrize("heads,seq,warps,grid", [
    (12, 257, 2, (12, 9)),     # the serving trunk: 108 blocks of 32 rows
    (12, 1, 2, (12, 1)), (1, 17, 2, (1, 1)), (2, 300, 2, (2, 10)),
    (44, 257, 4, (44, 5)),     # 64-row blocks once they fill the card
    (33, 200, 4, (33, 4)), (32, 200, 2, (32, 7)), (132, 64, 4, (132, 1))])
def test_attention_warps_and_grid(heads, seq, warps, grid):
    assert dl.attention_warps(heads, seq) == warps
    assert dl.attention_grid(heads, seq) == grid
    # four row warps only where that still gives every multiprocessor a block
    assert (warps == 4) == (heads * -(-seq // 64) >= dl.SMS)
    assert grid[1] * 16 * warps >= seq > (grid[1] - 1) * 16 * warps


def _key_shares(seq, key_warps=4):
    """The keys [c0, c1) each key warp of a row warp takes, as
    csrc/dino_layer.cu::attention_kernel cuts them: the 16-key chunks
    of the row, padded to 16, in contiguous shares of ceil(chunks / 4)."""
    s16 = -(-seq // 16) * 16
    per = -(-(s16 // 16) // key_warps)
    return [(k * per * 16, min(s16, (k + 1) * per * 16))
            for k in range(key_warps)]


@pytest.mark.parametrize("seq", [1, 16, 17, 64, 65, 257, 300, 320])
def test_key_shares_fit_the_registers_and_cover_the_keys(seq):
    assert seq <= dl.ATTENTION_MAX_SEQ
    shares = [(a, b) for a, b in _key_shares(seq) if a < b]
    assert shares[0][0] == 0 and shares[-1][1] >= seq
    assert all(b == c for (_, b), (c, _) in zip(shares, shares[1:]))
    # five chunks of 16 keys a warp, and every share that is not empty
    # holds a key below seq (its maximum is finite)
    assert all(b - a <= 80 and a < seq for a, b in shares)


def test_hold_seq_is_what_four_key_warps_hold():
    assert dl.ATTENTION_MAX_SEQ == 4 * 5 * 16
    # one chunk more and a share would need a sixth chunk
    s16 = dl.ATTENTION_MAX_SEQ + 16
    assert -(-(s16 // 16) // 4) == 6


def _attention_by_key_shares(qkv):
    """attention_reference's function in the order the kernel takes:
    per key share a row maximum and, against the row's maximum, a sum of
    exponentials; the sums added in share order; P = bf16(e / sum); per
    share a partial P.V in fp32, the partials added in share order and
    rounded once."""
    seq, width = qkv.shape
    hidden = width // 3
    heads = hidden // dl.HEAD_DIM

    def split(t):
        return t.reshape(seq, heads, dl.HEAD_DIM).transpose(0, 1).float()

    q, k, v = (split(qkv[:, i * hidden:(i + 1) * hidden]) for i in range(3))
    q = (q * 0.125).bfloat16().float()
    shares = [(a, min(b, seq)) for a, b in _key_shares(seq) if a < seq]
    scores = [(q @ k[:, a:b].transpose(1, 2)).bfloat16().float()
              for a, b in shares]
    row_max = torch.stack([s.amax(-1) for s in scores]).amax(0)[..., None]
    exps = [torch.exp(s - row_max) for s in scores]
    total = exps[0].sum(-1, keepdim=True)
    for e in exps[1:]:
        total = total + e.sum(-1, keepdim=True)
    out = None
    for e, (a, b) in zip(exps, shares):
        part = (e / total).bfloat16().float() @ v[:, a:b]
        out = part if out is None else out + part
    return out.bfloat16().transpose(0, 1).reshape(seq, hidden)


@pytest.mark.parametrize("seq,hidden", [(257, 768), (17, 64), (300, 128),
                                        (1, 64), (64, 128)])
def test_key_split_softmax_is_the_plain_function(seq, hidden):
    """Maxima and sums exchanged between key shares and partial outputs
    added afterwards give attention_reference's output up to the order of
    two fp32 sums: within one bf16 ulp of the output scale, nearly all
    entries equal."""
    rng = np.random.default_rng(seq + hidden)
    qkv = torch.tensor((rng.standard_normal((seq, 3 * hidden)) * 2.0).astype(
        np.float32)).bfloat16()
    ref = dl.attention_reference(qkv).float()
    got = _attention_by_key_shares(qkv).float()
    assert float((got - ref).abs().max()) <= 2 ** -7 * max(
        float(ref.abs().max()), 1.0)
    assert float((got != ref).float().mean()) < 0.02
