"""The port's differentiable bf16 DINOv2 trunk
(hypervla_tpu_torch/models/encoders/dinov2.py::dinov2_forward in bf16,
with the fused training attention on and off) against the JAX package's
DINOv2Model(dtype=bfloat16, fused_attention=...) on the same params and
pixels: the loss within 2e-2 rel and the parameter gradient at cosine >
0.99, the bounds tests/test_fused_attention.py holds between the JAX
package's own two trunks. The loss is sum(out * c) for a fixed random c:
that test's sum(out^2) after a unit-scale final LayerNorm is constant in
the trunk's output up to eps, so its trunk gradients are rounding noise,
which two implementations do not share."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervla_tpu.models.encoders import dinov2 as jd
from hypervla_tpu_torch import configs
from hypervla_tpu_torch.models.encoders import dinov2 as td
from hypervla_tpu_torch.utils.convert import from_jax_params
from test_torch_harness import torch_threads  # noqa: F401

GEOMETRY = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                patch_size=14, image_size=28)


@pytest.fixture(scope="module")
def pixels():
    rs = np.random.RandomState(0)
    return (rs.rand(2, 28, 28, 3).astype(np.float32),
            rs.randn(2, 5, 128).astype(np.float32))


def _jax_loss_and_grads(fused, pix, cot):
    model = jd.DINOv2Model(jd.DINOv2Config(**GEOMETRY), dtype=jnp.bfloat16,
                           fused_attention=fused)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(pix))["params"]

    def loss(p):
        out = model.apply({"params": p}, jnp.asarray(pix)).last_hidden_state
        return jnp.sum(out.astype(jnp.float32) * cot)

    value, grads = jax.value_and_grad(loss)(params)
    return params, float(value), from_jax_params(jax.device_get(grads))


@pytest.mark.parametrize("fused", [False, True])
def test_bf16_trunk_loss_and_grads_match_jax(fused, pixels):
    pixels, cot = pixels
    params, ref_loss, ref_grads = _jax_loss_and_grads(fused, pixels, cot)
    tparams = {k: v.requires_grad_(True)
               for k, v in from_jax_params(params).items()}
    out = td.dinov2_forward(configs.DINOv2Config(**GEOMETRY), tparams,
                            torch.tensor(pixels), torch.bfloat16,
                            fused_attention=fused)
    assert out.dtype == torch.float32
    loss = (out * torch.tensor(cot)).sum()
    loss.backward()
    loss = float(loss.detach())
    assert abs(loss - ref_loss) < 2e-2 * abs(ref_loss), (
        loss, ref_loss)
    keys = sorted(ref_grads)
    got = np.concatenate([tparams[k].grad.numpy().ravel()
                          if tparams[k].grad is not None
                          else np.zeros(tparams[k].numel(), np.float32)
                          for k in keys]).astype(np.float64)
    ref = np.concatenate([ref_grads[k].numpy().ravel()
                          for k in keys]).astype(np.float64)
    cos = got @ ref / (np.linalg.norm(got) * np.linalg.norm(ref))
    assert cos > 0.99, cos


def test_gelu_exact_backward_in_fp32_from_bf16_input():
    """The custom GELU keeps its bf16 input and differentiates in fp32, as
    the JAX package's _gelu_exact custom VJP does."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal(257).astype(np.float32) * 3
    xb = jnp.asarray(x, jnp.bfloat16)
    g = jnp.asarray(rng.standard_normal(257), jnp.bfloat16)
    ref_out, vjp = jax.vjp(jd._gelu_exact, xb)
    (ref_grad,) = vjp(g)
    xt = torch.tensor(np.asarray(xb.astype(jnp.float32))).bfloat16()
    xt.requires_grad_(True)
    out = td.GeluExact.apply(xt)
    out.backward(torch.tensor(np.asarray(g.astype(jnp.float32))).bfloat16())
    assert out.dtype == xt.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.detach().float().numpy(),
                                  np.asarray(ref_out, np.float32))
    # one bf16 ulp where the fp32 derivative rounds the other way
    np.testing.assert_allclose(xt.grad.float().numpy(),
                               np.asarray(ref_grad, np.float32),
                               rtol=2 ** -7, atol=1e-6)
