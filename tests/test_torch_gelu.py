"""The port's fused exact GELU (hypervla_tpu_torch/ops/gelu.py: CPU tensors
take the plain PyTorch version) against the JAX package's Pallas
`gelu_exact_fused` in interpret mode, and the switch that selects it in the
port's DINOv2 (HYPERVLA_FUSED_GELU=1, read at call time, and the JAX
package's size threshold).

Tolerances. The Pallas kernel evaluates erf by a rational polynomial, the
port calls erfc; tests/test_gelu_fused.py pins the two within 5e-6
absolute. fp32: 5e-6 absolute plus one fp32 ulp of the value (1.2e-7
relative). bf16: one ulp of the value's size, 2^-8 relative plus 5e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervla_tpu.ops.gelu import gelu_exact_fused as jax_gelu
from hypervla_tpu_torch.models.encoders import dinov2 as td
from hypervla_tpu_torch.ops import gelu as tg
from test_torch_harness import torch_threads  # noqa: F401


@pytest.mark.parametrize("shape", [(3, 257, 128), (7, 3072)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_pallas(dtype, shape):
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x = (np.random.RandomState(0).randn(*shape) * 3).astype(np.float32)
    ref = np.asarray(jax_gelu(jnp.asarray(x, jdt), block_rows=4),
                     np.float32)
    got = tg.gelu_exact_fused(torch.tensor(x).to(tdt))
    assert got.dtype == tdt and got.shape == shape
    got = got.float().numpy()
    rel = 1.2e-7 if dtype == "float32" else 2 ** -8
    assert (np.abs(got - ref) <= 5e-6 + rel * np.abs(ref)).all(), np.abs(
        got - ref).max()


def test_switch_selects_the_fused_forward(monkeypatch):
    """GeluExact takes the fused kernel's function only with
    HYPERVLA_FUSED_GELU=1 and at least 4*257*3072 elements; the backward
    does not change."""
    calls = []
    fused = td.gelu_exact_fused
    monkeypatch.setattr(td, "gelu_exact_fused",
                        lambda x: calls.append(x.shape) or fused(x))
    rs = np.random.RandomState(1)
    big = torch.tensor(rs.randn(4, 257, 3072).astype(np.float32)).bfloat16()
    small = big[:3]
    monkeypatch.delenv("HYPERVLA_FUSED_GELU", raising=False)
    off = td.GeluExact.apply(big)
    assert calls == []
    monkeypatch.setenv("HYPERVLA_FUSED_GELU", "1")
    td.GeluExact.apply(small)
    assert calls == []
    leaf = big.clone().requires_grad_(True)
    on = td.GeluExact.apply(leaf)
    assert calls == [big.shape]
    assert torch.equal(on, off)  # on the CPU both are the plain expression
    g = torch.tensor(rs.randn(*big.shape).astype(np.float32)).bfloat16()
    on.backward(g)
    ref = big.float().requires_grad_(True)
    torch.nn.functional.gelu(ref).backward(g.float())
    assert (leaf.grad.float() - ref.grad).abs().max() < 0.05
