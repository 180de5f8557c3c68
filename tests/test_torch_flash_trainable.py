"""The port's differentiable flash attention
(hypervla_tpu_torch/ops/flash_attention_train.py: CPU tensors take the
plain PyTorch versions) against the JAX package's `mha_flash_trainable`
(its einsum route off a TPU) and its VJP, on the same inputs, and a tiny
DINOv2 trunk with the switch on against the JAX DINOv2Model with it on:

  * the function, forward and jax.vjp (dq, dk, dv), at S = 1, 17, 33, head
    dims 16 and 64, two heads: fp32 to 1e-5; bf16 at the same rounding
    points, every entry within one bf16 ulp (ROADMAP.md's kernel note: an
    fp32 value at a bf16 rounding midpoint may round the other way when
    the sums run in another order);
  * the trunk's output and every parameter's gradient: fp32 to 1e-5 of
    the largest; bf16 within the bounds tests/test_torch_dinov2_train.py
    holds the bf16 trunk to;
  * the wrapper's own arithmetic: the scale and its bf16 terms, the
    residuals it saves, the forward under torch.no_grad();
  * the fp32 kernels' arithmetic: every fp32 operand as three bf16 terms
    whose sum is it exactly, and an emulation of the kernels' products
    (the six term products of SPLIT_PAIRS in their order, summed in fp32)
    and exponentials against the plain versions, within 1e-5 of scale.

The kernels themselves run only on the card
(tests/test_torch_flash_trainable_cuda.py, `cuda`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervla_tpu.models.encoders import dinov2 as jd
from hypervla_tpu.ops.flash_attention import mha_flash_trainable as jax_flash
from hypervla_tpu_torch import configs
from hypervla_tpu_torch.models.encoders import dinov2 as td
from hypervla_tpu_torch.ops import flash_attention_train as ft
from hypervla_tpu_torch.utils.convert import from_jax_params
from test_torch_column_gelu_redesign import bf16_ulps
from test_torch_harness import torch_threads  # noqa: F401

GEOMETRY = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                patch_size=14, image_size=28)


def _inputs(seq, d, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((2, seq, 2, d)).astype(np.float32)
            for _ in range(4)]
    jx = [jnp.asarray(a, dtype) for a in arrs]
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tx = [torch.tensor(np.asarray(a.astype(jnp.float32))).to(tdtype)
          for a in jx]
    return jx, tx


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("seq", [1, 17, 33])
def test_plain_version_matches_jax(seq, d, dtype):
    (q, k, v, g), (tq, tk, tv, tg) = _inputs(seq, d, dtype, seq * d)
    ref, vjp = jax.vjp(jax_flash, q, k, v)
    refs = [ref, *vjp(g)]
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = ft.mha_flash_trainable(*leaves)
    out.backward(tg)
    for name, got, want in zip(("o", "dq", "dk", "dv"),
                               [out.detach()] + [t.grad for t in leaves],
                               refs):
        assert got.dtype == tq.dtype and got.shape == tq.shape, name
        want = torch.tensor(np.asarray(want.astype(jnp.float32)))
        if dtype == jnp.float32:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=name)
        else:
            ulps = bf16_ulps(got.float(), want)
            assert float(ulps.max()) <= 1.0, (name, float(ulps.max()))


def test_the_scale_and_its_bf16_terms():
    """The scale is JAX's float64 1/sqrt(d) rounded to fp32; it is a power
    of two at head dims 16 and 64, where fp32(q) * scale is a bf16 value
    (one term), and not at 32 and 128 (three terms, whose sum is the fp32
    product exactly)."""
    for d in (16, 32, 64, 128):
        scale = ft.softmax_scale(d)
        assert scale == float(np.float32(1.0 / np.sqrt(d)))
        assert ft.q_terms(scale) == (1 if d in (16, 64) else 3)
    q = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    for d in (32, 128):
        x = q.bfloat16().float() * ft.softmax_scale(d)
        hi = x.bfloat16()
        mid = (x - hi.float()).bfloat16()
        lo = (x - hi.float() - mid.float()).bfloat16()
        assert torch.equal(hi.float() + mid.float() + lo.float(), x)


def test_forward_saves_row_stats_and_runs_without_grad():
    """The forward's residuals are the fp32 row max and row sum, (batch,
    heads, seq), from which the backward recomputes the probabilities;
    under torch.no_grad() the function gives the same output."""
    _, (tq, tk, tv, _) = _inputs(17, 16, jnp.bfloat16, 3)
    o, m, n = ft.mha_flash_trainable_fwd(tq, tk, tv)
    assert m.shape == n.shape == (2, 2, 17)
    assert m.dtype == n.dtype == torch.float32
    s = torch.einsum("bqhd,bkhd->bhqk", tq.float() * ft.softmax_scale(16),
                     tk.float())
    torch.testing.assert_close(m, s.amax(-1), rtol=0, atol=0)
    torch.testing.assert_close(n, torch.exp(s - m[..., None]).sum(-1))
    with torch.no_grad():
        again = ft.mha_flash_trainable(tq, tk, tv)
    assert torch.equal(again, o)
    plain = ft.mha_flash_trainable_reference(tq, tk, tv)
    assert torch.equal(plain, o)


#: CUDA's grid limits (x, y) and a block's shared memory on an H100
GRID_LIMITS = (2 ** 31 - 1, 65535)
SMEM_LIMIT = 232448


def _groups(seq, tile, width):
    """The `width`-wide groups of the `tile`-long tiles that cut [0, seq)
    which hold a live index."""
    return len({(i // tile, i % tile // width) for i in range(seq)})


@pytest.mark.parametrize("seq", [1, 16, 17, 64, 65, 257, 300, 2048])
@pytest.mark.parametrize("d", [16, 20, 32, 64, 128])
@pytest.mark.parametrize("batch_heads", [12, 768])
def test_plan_fits_the_card_and_covers_the_rows(batch_heads, d, seq):
    """flash_train_plan: every kernel's shared memory fits a block, the
    grids are within CUDA's limits, the row blocks cover every row and
    the last holds a live one, and the work counts are the kernels' cuts:
    bf16, each 16-row warp with a live row multiplies, over each key
    tile's 8-key groups with a live key (exponentials) and 16-key groups
    (products); fp32, every row of its 64-row blocks, over the 8-key
    groups and whole 64-key tiles; counted here row by row and key by
    key. Every fp32 shape takes the fp32 route."""
    for dtype in (torch.bfloat16, torch.float32):
        plan = ft.flash_train_plan(batch_heads, seq, d, dtype)
        assert max(plan.smem_fwd, plan.smem_dq, plan.smem_dkdv) \
            <= SMEM_LIMIT, plan
        grid, rows = plan.grid, plan.rows
        assert all(1 <= g <= lim for g, lim in zip(grid, GRID_LIMITS))
        assert grid[1] == batch_heads
        assert (grid[0] - 1) * rows < seq <= grid[0] * rows
        assert plan.live_work == seq * seq
        # every fp32 shape takes the fp32 route: all its operands as three
        # bf16 terms, whatever the head dim
        f32 = dtype == torch.float32
        assert plan.route == ("fp32_split" if f32 else "bf16")
        dn = plan.padded_dim
        assert (plan.smem_fwd, plan.smem_dq, plan.smem_dkdv) == (
            ft.fp32_smem(dn) if f32 else ft.bf16_smem(plan.q_terms, dn))
        assert plan.rows == 64 if f32 else plan.rows in (16, 32, 64)
        # fp32: whole 64-row blocks and 64-key products on `wgmma`
        live_rows = rows * grid[0] if f32 else 16 * _groups(seq, rows, 16)
        width = 64 if f32 else 16
        assert plan.score_work == \
            live_rows * 8 * _groups(seq, plan.key_tile, 8)
        assert plan.product_work == \
            live_rows * width * _groups(seq, plan.key_tile, width)
        assert plan.padded_dim in (64, 128) and plan.padded_dim >= d
        assert plan.q_terms == (3 if f32 else ft.q_terms(ft.softmax_scale(d)))


def test_plan_cuts_the_padding_at_the_flagship_shape():
    """At the training shape (64 x 12 heads, 257 tokens, head dim 64) the
    blocks take 64 rows (a `wgmma` warpgroup) and the scores each sweep
    forms are within 1.1x of the live ones (rows in 16s, keys in 8s; the
    first version's 64 x 64 tiles formed 320^2 / 257^2 = 1.55x); the
    serving shape (12 heads of one image) takes 16-row blocks, 204 of
    them, rather than 60 of 64 rows for 132 multiprocessors."""
    train = ft.flash_train_plan(768, 257, 64, torch.bfloat16)
    assert train.rows == 64 and train.grid == (5, 768)
    assert train.score_work <= 1.1 * train.live_work
    assert train.score_work == 272 * 264
    assert train.product_work == 272 * 272
    serve = ft.flash_train_plan(12, 257, 64, torch.bfloat16)
    assert serve.rows == 16 and serve.grid == (17, 12)
    assert ft.flash_train_plan(12, 257, 64, torch.bfloat16, sms=1).rows == 64


def test_inputs_of_two_types_raise():
    _, (tq, tk, tv, _) = _inputs(5, 16, jnp.float32, 4)
    with pytest.raises(ValueError, match="bf16 or all fp32"):
        ft.mha_flash_trainable(tq, tk.bfloat16(), tv)
    with pytest.raises(ValueError, match="shape"):
        ft.mha_flash_trainable(tq, tk[:, :3], tv[:, :3])


@pytest.fixture(scope="module")
def pixels():
    rs = np.random.RandomState(0)
    return (rs.rand(2, 28, 28, 3).astype(np.float32),
            rs.randn(2, 5, 128).astype(np.float32))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["fp32", "bf16"])
def test_tiny_trunk_with_the_switch_matches_jax(pixels, dtype, monkeypatch):
    """DINOv2Model(use_flash=True, flash_trainable=True) and the port's
    dinov2_forward with the same switches, on the same params and pixels:
    the loss sum(out * c) and every parameter's gradient."""
    pix, cot = pixels
    model = jd.DINOv2Model(jd.DINOv2Config(**GEOMETRY), dtype=dtype,
                           use_flash=True, flash_trainable=True)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(pix))["params"]

    def loss(p):
        out = model.apply({"params": p}, jnp.asarray(pix)).last_hidden_state
        return jnp.sum(out.astype(jnp.float32) * cot)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss))(params)
    ref_grads = from_jax_params(jax.device_get(ref_grads))
    tparams = {k: v.requires_grad_(True)
               for k, v in from_jax_params(params).items()}
    calls = []
    monkeypatch.setattr(
        td, "mha_flash_trainable",
        lambda *a: calls.append(1) or ft.mha_flash_trainable(*a))
    out = td.dinov2_forward(
        configs.DINOv2Config(**GEOMETRY), tparams, torch.tensor(pix),
        torch.float32 if dtype == jnp.float32 else torch.bfloat16,
        use_flash=True, flash_trainable=True)
    assert len(calls) == GEOMETRY["num_hidden_layers"]
    got_loss = (out * torch.tensor(cot)).sum()
    got_loss.backward()
    got = {k: (t.grad if t.grad is not None else torch.zeros_like(t)).numpy()
           for k, t in tparams.items()}
    ref = {k: v.numpy() for k, v in ref_grads.items()}
    assert set(got) == set(ref)
    if dtype == jnp.float32:
        np.testing.assert_allclose(float(got_loss.detach()),
                                   float(ref_loss), rtol=1e-5)
        scale = max(np.abs(v).max() for v in ref.values())
        for name in ref:
            err = np.abs(got[name] - ref[name]).max()
            assert err <= 1e-5 * scale, (name, err, scale)
    else:
        assert abs(float(got_loss.detach()) - float(ref_loss)) < 2e-2 * abs(
            float(ref_loss))
        a = np.concatenate([got[k].ravel() for k in sorted(ref)])
        b = np.concatenate([ref[k].ravel() for k in sorted(ref)])
        a, b = a.astype(np.float64), b.astype(np.float64)
        assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.99


# ------------------------- the fp32 kernels' arithmetic -------------------------

#: the term products (i, j) whose fp32 sum is an fp32 product a . b in the
#: fp32 kernels (a_i . b_j, i + j <= 2; the three left out are each below
#: 2^-23 |a||b|), in the order they add them (csrc/flash_attention_train.cu
#: `pair_a`, `pair_b`, `rs_pairs`): the small ones first, hi . hi last
SPLIT_PAIRS = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))


def split_terms(x):
    """The three bf16 terms (hi, mid, lo) of an fp32 tensor, as the kernels
    form them (`split3`): hi = bf16(x), mid = bf16(x - hi), lo = bf16(x -
    hi - mid), each difference in fp32."""
    hi = x.bfloat16()
    rest = x - hi.float()
    mid = rest.bfloat16()
    return hi, mid, (rest - mid.float()).bfloat16()


@pytest.mark.parametrize("what", ["unit", "wide", "qs32", "qs128"])
def test_the_three_terms_sum_to_the_fp32_value(what):
    """hi + mid + lo == x bit for bit over seeded fp32 values: unit
    normals, values over 2^-60 .. 2^60, and qs = fp32(q) * scale at head
    dims 32 and 128 (the scales that are no power of two)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal(1 << 16).astype(np.float32)
    if what == "wide":
        x *= np.exp2(rng.uniform(-60, 60, x.shape)).astype(np.float32)
    elif what.startswith("qs"):
        x *= np.float32(ft.softmax_scale(int(what[2:])))
    x = torch.tensor(x)
    terms = split_terms(x)
    assert all(t.dtype == torch.bfloat16 for t in terms)
    total = sum(t.double() for t in terms)
    assert torch.equal(total, x.double())
    hi, mid, lo = (t.float() for t in terms)
    assert torch.equal(hi + mid + lo, x)
    # each term below the last's rounding: |mid| <= 2^-8 |hi|, the same on
    assert bool((mid.abs() <= hi.abs() * 2 ** -8).all())
    assert bool((lo.abs() <= mid.abs() * 2 ** -8).all())


def _split_product(a, b):
    """a . b as the fp32 kernels form it: the six term products of
    SPLIT_PAIRS, each exact bf16 products summed in fp32, added in the
    kernels' order, the small ones first."""
    ta, tb = split_terms(a), split_terms(b)
    out = None
    for i, j in SPLIT_PAIRS:
        term = ta[i].float() @ tb[j].float()
        out = term if out is None else out + term
    return out


def _expo(x, m):
    """exp(x - m) as the kernels form it: 2^(x log2(e) - m log2(e)), the
    argument one fp32 FMA from m's product (here in fp64, rounded)."""
    cl = torch.tensor(1.4426950408889634, dtype=torch.float32)
    nml = -(m * cl)
    return torch.exp2((x.double() * cl.double() + nml.double()).float())


def _emulate(q, k, v, g):
    """The fp32 kernels' forward and backward on (B, S, H, D) inputs:
    (o, m, n), (dq, dk, dv)."""
    scale = ft.softmax_scale(q.shape[-1])
    qs, kf, vf, gf = (t.transpose(1, 2) for t in (q * scale, k, v, g))
    s = _split_product(qs, kf.transpose(-1, -2))
    m = s.amax(-1)
    e = _expo(s, m[..., None])
    n = e.sum(-1)
    rn = 1 / n[..., None]
    p = e * rn
    o = _split_product(p, vf)
    dp = _split_product(gf, vf.transpose(-1, -2))
    r = (dp * (1 / (n * n))[..., None] * e).sum(-1, keepdim=True)
    ds = (dp * rn - r) * e
    dq = _split_product(ds, kf) * scale
    dk = _split_product(ds.transpose(-1, -2), qs)
    dv = _split_product(p.transpose(-1, -2), gf)
    return (o.transpose(1, 2), m, n), tuple(
        t.transpose(1, 2) for t in (dq, dk, dv))


@pytest.mark.parametrize("shape", [(2, 257, 3, 64), (2, 17, 3, 128)],
                         ids=str)
def test_the_split_arithmetic_matches_the_plain_versions(shape):
    """The emulated fp32 kernels against mha_flash_trainable_fwd_reference
    and _bwd_reference (the latter from the reference's own m, n), each
    output within 1e-5 of its scale (max(|ref|, 1)), the bound the card's
    kernels are held to; the margin reached is printed."""
    rng = np.random.default_rng(shape[1])
    q, k, v, g = (torch.tensor(rng.standard_normal(shape).astype(np.float32))
                  for _ in range(4))
    fwd, bwd = _emulate(q, k, v, g)
    ref_fwd = ft.mha_flash_trainable_fwd_reference(q, k, v)
    ref_bwd = ft.mha_flash_trainable_bwd_reference(q, k, v, g, *ref_fwd[1:])
    margins = {}
    for name, got, ref in zip(("o", "m", "n", "dq", "dk", "dv"),
                              (*fwd, *bwd), (*ref_fwd, *ref_bwd)):
        tol = 1e-5 * max(float(ref.abs().max()), 1.0)
        err = float((got.float() - ref).abs().max())
        margins[name] = err / tol
        assert err <= tol, (name, err, tol)
    print(f"{shape}: error / bound " + ", ".join(
        f"{k} {v:.3f}" for k, v in margins.items()))
