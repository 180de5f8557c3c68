"""The port's flash attention (hypervla_tpu_torch/ops/flash_attention.py:
CPU tensors take the plain PyTorch version) against the JAX package's Pallas
`flash_attention` / `mha_flash` in interpret mode, on the shapes of
tests/test_flash_attention.py: unpadded (128), ragged (257, the kernel pads
and masks), Lq != Lk, the (batch, seq, heads, d) layout, bf16.

Tolerances. fp32: 2e-5 absolute, the JAX test's own bound against its
reference (the Pallas kernel's streaming softmax sums in another order than
the plain full softmax). bf16: one ulp of the output's largest value,
2^-7 * max(scale, 1): both sides compute in fp32 and round once.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervla_tpu.ops.flash_attention import flash_attention as jax_flash
from hypervla_tpu.ops.flash_attention import mha_flash as jax_mha_flash
from hypervla_tpu_torch.ops import flash_attention as tfa
from test_torch_harness import torch_threads  # noqa: F401


def _qkv(shape_q, shape_kv, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(*shape_q).astype(np.float32),
            rs.randn(*shape_kv).astype(np.float32),
            rs.randn(*shape_kv).astype(np.float32))


def _err(got, ref):
    got, ref = got.float().numpy(), np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all()
    return np.abs(got - ref).max(), np.abs(ref).max()


@pytest.mark.parametrize("q_len,kv_len", [(128, 128), (257, 257), (40, 257)])
def test_fp32_matches_pallas(q_len, kv_len):
    q, k, v = _qkv((2, q_len, 64), (2, kv_len, 64))
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    interpret=True)
    tfa.reset_launch_counts()
    got = tfa.flash_attention(*(torch.tensor(a) for a in (q, k, v)))
    assert tfa.LAUNCHES["flash_attention"] == 0  # CPU: the plain version
    err, _ = _err(got, ref)
    assert err <= 2e-5, err


@pytest.mark.parametrize("q_len,kv_len", [(257, 257), (40, 257)])
def test_bf16_matches_pallas(q_len, kv_len):
    q, k, v = _qkv((2, q_len, 64), (2, kv_len, 64), seed=1)
    ref = jax_flash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                    interpret=True)
    got = tfa.flash_attention(*(torch.tensor(a).bfloat16()
                                for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    err, scale = _err(got, ref)
    assert err <= 2 ** -7 * max(scale, 1.0), (err, scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_layout_matches_pallas(dtype):
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    q, k, v = _qkv((2, 30, 4, 16), (2, 30, 4, 16), seed=2)
    ref = jax_mha_flash(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                        interpret=True)
    got = tfa.mha_flash(*(torch.tensor(a).to(tdt) for a in (q, k, v)))
    assert got.shape == (2, 30, 4, 16)
    err, scale = _err(got, ref)
    tol = 2e-5 if dtype == "float32" else 2 ** -7 * max(scale, 1.0)
    assert err <= tol, (err, scale)


def test_q_is_scaled_in_fp32_and_p_stays_fp32():
    """What sets this function apart from the einsum path (q divided in
    bf16, P rounded to bf16): on bf16 inputs the output equals the fp32
    computation on the same values rounded once."""
    q, k, v = (torch.tensor(a).bfloat16()
               for a in _qkv((1, 50, 64), (1, 50, 64), seed=3))
    exact = tfa.flash_attention_reference(q.float(), k.float(), v.float())
    assert torch.equal(tfa.flash_attention(q, k, v), exact.bfloat16())


def test_forward_only_and_checks():
    q, k, v = (torch.tensor(a) for a in _qkv((1, 8, 16), (1, 8, 16)))
    with pytest.raises(RuntimeError, match="forward only"):
        tfa.flash_attention(q.requires_grad_(True), k, v)
    with torch.no_grad():  # as the serving step calls it
        assert tfa.flash_attention(q, k, v).shape == (1, 8, 16)
    with pytest.raises(ValueError, match="one type"):
        tfa.flash_attention(q.detach().bfloat16(), k, v)
    with pytest.raises(ValueError, match="shapes"):
        tfa.flash_attention(q.detach(), k[:, :4], v)
