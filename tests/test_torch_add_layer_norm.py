"""The port's fused residual add + LayerNorm (hypervla_tpu_torch/ops/
add_layer_norm.py: CPU tensors take the plain PyTorch versions) against the
JAX package's Pallas `fused_add_ln` and `fused_add_scale_ln` in interpret
mode, forward and gradients, fp32 and bf16, on the shapes of
tests/test_add_layer_norm.py (114 rows in blocks of 32 leave a partial
block), with both cotangents and with only y's.

Tolerances. x_new: the same bits (an add, or a multiply and an add, each
rounded to the type), but in fp32 with a LayerScale one fp32 ulp of the
largest value, since XLA's CPU compiler fuses the multiply and the add
into one FMA there. y: fp32 1e-5, bf16 one ulp of its largest value
(2^-7 * max(scale, 1)). dx, ddelta: fp32 1e-4 absolute, bf16 one ulp of
their largest value. The column sums dscale, dbias, dls, relative to their
largest value: fp32 1e-5 (the Pallas kernel sums bf16 hi/lo halves, the
port sums in fp32), bf16 0.02 (the JAX test's own bound).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervla_tpu.ops.add_layer_norm import fused_add_ln as jax_add_ln
from hypervla_tpu.ops.add_layer_norm import (
    fused_add_scale_ln as jax_add_scale_ln,
)
from hypervla_tpu_torch.ops import add_layer_norm as aln
from test_torch_harness import torch_threads  # noqa: F401

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _setup(shape, with_ls):
    rs = np.random.RandomState(0)
    x = (rs.randn(*shape) * 2).astype(np.float32)
    delta = rs.randn(*shape).astype(np.float32)
    scale = (rs.rand(shape[-1]) + 0.5).astype(np.float32)
    bias = (rs.randn(shape[-1]) * 0.1).astype(np.float32)
    ls = (0.3 + 0.05 * rs.randn(shape[-1])).astype(np.float32)
    return (x, delta, ls, scale, bias) if with_ls else (x, delta, scale, bias)


def _both(args, dtype, with_ls):
    """The same arrays for both packages: x and delta in `dtype`, the
    vectors fp32."""
    jdt, tdt = DTYPES[dtype]
    jargs = [jnp.asarray(a, jdt if i < 2 else jnp.float32)
             for i, a in enumerate(args)]
    targs = [torch.tensor(a).to(tdt if i < 2 else torch.float32)
             for i, a in enumerate(args)]
    fns = ((jax_add_scale_ln, aln.fused_add_scale_ln) if with_ls
           else (jax_add_ln, aln.fused_add_ln))
    return jargs, targs, fns


def _err(got, ref):
    got, ref = got.float().numpy(), np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all()
    return np.abs(got - ref).max(), np.abs(ref).max()


@pytest.mark.parametrize("with_ls", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 33, 768), (257, 256)])
def test_forward_matches_pallas(dtype, shape, with_ls):
    jargs, targs, (jfn, tfn) = _both(_setup(shape, with_ls), dtype, with_ls)
    ref_xn, ref_y = jfn(*jargs, 1e-6)
    aln.reset_launch_counts()
    xn, y = tfn(*targs, 1e-6)
    assert sum(aln.LAUNCHES.values()) == 0  # CPU: the plain versions
    assert xn.dtype == y.dtype == DTYPES[dtype][1]
    ref_xn = np.asarray(ref_xn, np.float32)
    if with_ls and dtype == "float32":
        # XLA's CPU compiler contracts x + ls * delta into one FMA; the port
        # rounds the product first, as the bf16 path has to
        assert np.abs(xn.numpy() - ref_xn).max() <= 2 ** -23 * np.abs(
            ref_xn).max()
    else:
        np.testing.assert_array_equal(xn.float().numpy(), ref_xn)
    err, scale = _err(y, ref_y)
    tol = 1e-5 if dtype == "float32" else 2 ** -7 * max(scale, 1.0)
    assert err <= tol, (err, scale)


@pytest.mark.parametrize("with_ls", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grads_match_pallas_both_cotangents(dtype, with_ls):
    shape = (2, 57, 768)
    jargs, targs, (jfn, tfn) = _both(_setup(shape, with_ls), dtype, with_ls)
    rs = np.random.RandomState(1)
    gxn, gy = (rs.randn(*shape).astype(np.float32) for _ in range(2))
    jdt, tdt = DTYPES[dtype]
    _, vjp = jax.vjp(lambda *a: jfn(*a, 1e-6, 32), *jargs)
    refs = vjp((jnp.asarray(gxn, jdt), jnp.asarray(gy, jdt)))

    leaves = [t.requires_grad_(True) for t in targs]
    xn, y = tfn(*leaves, 1e-6)
    torch.autograd.backward((xn, y), (torch.tensor(gxn).to(tdt),
                                      torch.tensor(gy).to(tdt)))
    grads = [t.grad for t in leaves]
    assert grads[0].dtype == grads[1].dtype == tdt
    assert all(g.dtype == torch.float32 for g in grads[2:])
    if not with_ls:  # x + delta is symmetric: one gradient for both
        assert torch.equal(grads[0], grads[1])
    for got, ref in zip(grads[:2], refs[:2]):
        err, scale = _err(got, ref)
        tol = 1e-4 if dtype == "float32" else 2 ** -7 * max(scale, 1.0)
        assert err <= tol, (err, scale)
    for got, ref in zip(grads[2:], refs[2:]):
        err, scale = _err(got, ref)
        assert err <= (1e-5 if dtype == "float32" else 0.02) * scale, (
            err, scale)


@pytest.mark.parametrize("with_ls", [False, True])
def test_only_y_cotangent(with_ls):
    """The residual-stream output may be unused (the last boundary):
    autograd then passes no cotangent for it, which reads as zeros."""
    jargs, targs, (jfn, tfn) = _both(_setup((8, 768), with_ls), "float32",
                                     with_ls)
    refs = jax.grad(lambda *a: jnp.sum(jfn(*a, 1e-6)[1] ** 2),
                    argnums=(0, 1))(*jargs)
    leaves = [t.requires_grad_(True) for t in targs]
    (tfn(*leaves, 1e-6)[1] ** 2).sum().backward()
    for got, ref in zip((leaves[0].grad, leaves[1].grad), refs):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_only_x_new_cotangent_and_param_dtypes():
    """Only the residual stream's cotangent: dx is that cotangent, ddelta
    is it times ls, the LayerNorm params get zeros. Gradients come back in
    the params' own types."""
    x, delta, ls, scale, bias = (torch.tensor(a) for a in _setup((5, 48),
                                                                 True))
    leaves = [x.bfloat16().requires_grad_(True),
              delta.bfloat16().requires_grad_(True), ls.requires_grad_(True),
              scale.bfloat16().requires_grad_(True),
              bias.bfloat16().requires_grad_(True)]
    xn, _ = aln.fused_add_scale_ln(*leaves, 1e-6)
    g = torch.randn(5, 48, generator=torch.Generator().manual_seed(0))
    xn.backward(g.bfloat16())
    assert torch.equal(leaves[0].grad, g.bfloat16())
    assert torch.equal(leaves[1].grad,
                       (g.bfloat16().float() * ls).bfloat16())
    assert leaves[3].grad.dtype == leaves[4].grad.dtype == torch.bfloat16
    assert not leaves[3].grad.any() and not leaves[4].grad.any()
    torch.testing.assert_close(
        leaves[2].grad, (g.bfloat16().float() * delta.bfloat16().float()
                         ).sum(0), rtol=1e-5, atol=1e-5)


def test_argument_checks():
    x, delta, scale, bias = (torch.tensor(a) for a in _setup((4, 16), False))
    with pytest.raises(ValueError, match="one shape and type"):
        aln.fused_add_ln(x, delta.bfloat16(), scale, bias)
    with pytest.raises(ValueError, match=r"\(d,\)"):
        aln.fused_add_ln(x, delta, scale[:8], bias)
