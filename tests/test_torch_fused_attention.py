"""The port's fused training MHA (hypervla_tpu_torch/ops/fused_attention.py:
CPU tensors take the plain PyTorch versions) against the JAX package's
Pallas `mha_fused_train` in interpret mode, forward (o and the bf16
probabilities) and backward (dq, dk, dv through the autograd.Function
against the Pallas VJP), on the same bf16 inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervla_tpu.ops import fused_attention as jfa
from hypervla_tpu_torch.ops import fused_attention as tfa
from test_torch_harness import torch_threads  # noqa: F401

S, H, D = 33, 4, 64
SCALE = 1.0 / np.sqrt(D)


def _inputs(batch, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((batch, S, H * D)).astype(np.float32)
            for _ in range(4)]
    jx = [jnp.asarray(a, jnp.bfloat16) for a in arrs]
    # the same bf16 values on both sides
    tx = [torch.tensor(np.asarray(a.astype(jnp.float32))).bfloat16()
          for a in jx]
    return jx, tx


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


@pytest.mark.parametrize("batch", [4, 2, 3])
def test_forward_matches_pallas(batch):
    (q, k, v, _), (tq, tk, tv, _) = _inputs(batch)
    ref_o, (_, _, _, ref_p) = jfa._mha_fwd(q, k, v, H, SCALE)
    got_o, got_p = tfa.mha_fused_train_fwd(tq, tk, tv, H, SCALE)
    assert got_o.dtype == got_p.dtype == torch.bfloat16
    assert got_p.shape == (batch, H, S, S)
    # the JAX test's bound: identical rounding points, sums in another order
    assert np.abs(_f32(got_o) - _f32(ref_o)).max() <= 2e-3
    assert np.abs(_f32(got_p) - _f32(ref_p)).max() <= 2e-3
    o_only, none = tfa.mha_fused_train_fwd(tq, tk, tv, H, SCALE,
                                           store_p=False)
    assert none is None and torch.equal(o_only, got_o)


def _cosine(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


@pytest.mark.parametrize("batch", [4, 2, 3])
def test_backward_matches_pallas_vjp(batch):
    (q, k, v, g), (tq, tk, tv, tg) = _inputs(batch, seed=1)
    _, vjp = jax.vjp(lambda q, k, v: jfa.mha_fused_train(q, k, v, H, SCALE),
                     q, k, v)
    refs = vjp(g)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = tfa.mha_fused_train(*leaves, H, SCALE)
    out.backward(tg)
    for name, ref, leaf in zip("qkv", refs, leaves):
        got, ref = _f32(leaf.grad), _f32(ref)
        assert leaf.grad.dtype == torch.bfloat16
        assert _cosine(got, ref) > 0.999, name
        # ds is rounded to bf16 before two more products
        bound = 2 ** -6 * max(np.abs(ref).max(), 1.0)
        assert np.abs(got - ref).max() <= bound, (name,
                                                  np.abs(got - ref).max())


def test_plain_backward_tracks_fp32_autodiff():
    """The plain backward from the saved bf16 probabilities agrees with fp32
    autograd through the einsum attention it replaces."""
    (_, _, _, _), (tq, tk, tv, tg) = _inputs(2, seed=2)
    leaves = [t.float().requires_grad_(True) for t in (tq, tk, tv)]

    def einsum_path(q, k, v):
        q2 = q * tfa._bf16_scale(SCALE)
        s = torch.einsum("bqhd,bkhd->bhqk", *(t.reshape(2, S, H, D)
                                              for t in (q2, k)))
        p = torch.softmax(s, -1)
        return torch.einsum("bhqk,bkhd->bqhd", p,
                            v.reshape(2, S, H, D)).reshape(2, S, H * D)

    einsum_path(*leaves).backward(tg.float())
    got = tfa.mha_fused_train_bwd_reference(
        tq, tk, tv, tfa.mha_fused_train_fwd_reference(tq, tk, tv, H,
                                                      SCALE)[1],
        tg, H, SCALE)
    for leaf, g in zip(leaves, got):
        assert _cosine(_f32(g), leaf.grad.numpy()) > 0.99
