"""The port's DINOv2 training layer with residuals and its backward
(hypervla_tpu_torch/ops/dino_layer_train.py: CPU tensors take the plain
PyTorch versions) against the JAX package's Pallas kernels in interpret
mode: `_fwd_call(with_res=True)` for the residual-saving forward, and
`jax.vjp(dino_layer_train)` with a fixed random cotangent for every
backward output. 128 wide, 2 heads, one layer, ragged (batch, seq).

Tolerances. Forward outputs and residuals, and the gradients' largest
element: 2^-6 * max(scale, 1), two bf16 ulps of the tensor's largest value
(the two sides round at the same points; XLA keeps excess precision inside
a fusion, so a value may land one ulp away). Gradients also per output at
cosine > 0.999, ten times tighter than the JAX package holds its kernel to
against the flax trunk (tests/test_dino_layer_train.py: 0.99).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervla_tpu.ops import dino_layer_train as jdl
from hypervla_tpu_torch.ops import dino_layer_train as tdl
from test_torch_dino_layer_train import HEADS, _operands
from test_torch_harness import torch_threads  # noqa: F401

EPS = 1e-6
BOUND = 2 ** -6
GRADS = ("dx", "dwq", "dwk", "dwv", "dwo", "dw1", "dw2", "dpv", "db1")
PV_ROWS = ("bq", "bk", "bv", "bo", "b2", "ln1_s", "ln1_b", "ln2_s", "ln2_b",
           "ls1", "ls2")


def _jax_args(x, weights, pv, b1):
    bf = jnp.bfloat16
    return (jnp.asarray(x, bf), *(jnp.asarray(w, bf) for w in weights),
            jnp.asarray(pv), jnp.asarray(b1))


def _torch_args(x, weights, pv, b1, requires_grad=False):
    tb = torch.bfloat16
    args = [torch.tensor(x).to(tb), *(torch.tensor(w).to(tb) for w in weights),
            torch.tensor(pv), torch.tensor(b1)]
    return [t.requires_grad_(requires_grad) for t in args]


def _close(name, got, ref):
    got, ref = got.float().numpy(), np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all(), name
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= BOUND * max(scale, 1.0), (name, err, scale)


def _cosine(a, b):
    a = a.float().numpy().ravel().astype(np.float64)
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("batch,seq", [(4, 17), (3, 33)])
def test_forward_with_residuals_matches_pallas(batch, seq):
    operands = _operands(batch, seq)
    ref = jdl._fwd_call(*_jax_args(*operands), HEADS, EPS, with_res=True,
                        interpret=True)
    x, *rest = _torch_args(*operands)
    out, residuals = tdl.forward_with_residuals(
        x, tdl.pack_operands(*rest), HEADS, EPS)
    names = ("out", *tdl.RESIDUALS[:6])
    for name, got, want in zip(names, (out, *residuals[:6]), ref):
        _close(name, got, want)
    # ao, kept where the TPU kernel recomputes it: P.V of the stored P
    probs = residuals[2].float()
    v = residuals[1][..., 2 * x.shape[-1]:].float()
    b, s, h = x.shape
    vh = v.reshape(b, s, HEADS, h // HEADS).transpose(1, 2)
    ao = (probs @ vh).bfloat16().transpose(1, 2).reshape(b, s, h)
    assert torch.equal(residuals[6], ao)


@pytest.mark.parametrize("batch,seq", [(4, 17), (3, 33)])
def test_backward_matches_pallas_vjp(batch, seq):
    operands = _operands(batch, seq)
    cot = np.random.default_rng(7).standard_normal(
        operands[0].shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jdl.dino_layer_train(*a, HEADS, EPS),
                     *_jax_args(*operands))
    ref = vjp(jnp.asarray(cot, jnp.bfloat16))

    args = _torch_args(*operands, requires_grad=True)
    out = tdl.dino_layer_train(*args, HEADS, EPS)
    # sum(out * c) for a fixed random c, not sum(out ** 2)
    out.backward(torch.tensor(cot).bfloat16())
    for name, leaf, want in zip(GRADS, args, ref):
        got = leaf.grad
        assert got.dtype == leaf.dtype, name
        _close(name, got, want)
        if name != "dpv":
            assert _cosine(got, want) > 0.999, name
    dpv, ref_pv = args[7].grad, np.asarray(ref[7], np.float32)
    typical = float(np.median(np.abs(ref_pv).max(axis=1)))
    for i, row in enumerate(PV_ROWS):
        if row == "bk":
            # softmax ignores a uniform key shift: the exact gradient is 0,
            # both sides hold rounding noise, which must be as small
            assert np.abs(ref_pv[i]).max() < 1e-2 * typical
            assert float(dpv[i].abs().max()) < 1e-2 * typical
        else:
            assert _cosine(dpv[i], ref_pv[i]) > 0.999, row


def test_backward_wrapper_equals_autograd():
    """`layer_backward` on the saved residuals is what autograd runs."""
    operands = _operands(2, 9, seed=1)
    args = _torch_args(*operands, requires_grad=True)
    cot = torch.tensor(np.random.default_rng(3).standard_normal(
        operands[0].shape).astype(np.float32)).bfloat16()
    tdl.dino_layer_train(*args, HEADS, EPS).backward(cot)
    plain = [t.detach() for t in args]
    ops = tdl.pack_operands(*plain[1:])
    _, residuals = tdl.forward_with_residuals(plain[0], ops, HEADS, EPS)
    dx, dwqkv, dwo, dw1, dw2, dpv, db1 = tdl.layer_backward(
        cot, plain[0], ops, residuals, HEADS, EPS)
    h = plain[0].shape[-1]
    direct = (dx, dwqkv[:, :h], dwqkv[:, h:2 * h], dwqkv[:, 2 * h:], dwo, dw1,
              dw2, dpv, db1[None])
    for name, leaf, got in zip(GRADS, args, direct):
        assert torch.equal(leaf.grad, got), name


def test_primal_equals_residual_saving_forward():
    """The call with no gradient asked for (no residual outputs) and the
    residual-saving forward under autograd give the same bits."""
    operands = _operands(4, 17)
    with torch.no_grad():
        primal = tdl.dino_layer_train(*_torch_args(*operands), HEADS, EPS)
    saved = tdl.dino_layer_train(*_torch_args(*operands, requires_grad=True),
                                 HEADS, EPS)
    assert saved.requires_grad and not primal.requires_grad
    assert torch.equal(primal, saved.detach())


def test_weight_grads_sum_over_the_batch():
    """The weight gradients at batch 4 equal the sum over two half batches:
    rtol 0.05 as the JAX package holds its kernel to, with one bf16 ulp of
    the leaf's largest value as atol (each call rounds its own bf16
    cotangents and its own sum once)."""
    operands = _operands(4, 17)
    cot = torch.ones(operands[0].shape).bfloat16()

    def grads(sl):
        args = _torch_args(*operands, requires_grad=True)
        x = args[0].detach()[sl].requires_grad_(True)
        tdl.dino_layer_train(x, *args[1:], HEADS, EPS).backward(cot[sl])
        return [t.grad.float().numpy() for t in args[1:]]

    full, a, b = grads(slice(None)), grads(slice(0, 2)), grads(slice(2, 4))
    for name, f, ga, gb in zip(GRADS[1:], full, a, b):
        np.testing.assert_allclose(f, ga + gb, rtol=0.05,
                                   atol=2 ** -7 * np.abs(f).max(),
                                   err_msg=name)
