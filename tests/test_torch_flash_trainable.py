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
    residuals it saves, the forward under torch.no_grad().

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
