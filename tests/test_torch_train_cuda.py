"""The training slice's CUDA kernels against their plain PyTorch versions,
on the card, at the flagship's widths (S=257, H=12, D=64, width 768):
the fused training attention forward and backward
(csrc/fused_attention.cu) and the no-residual layer forward
(ops/dino_layer_train.py over csrc/dino_layer.cu and the attention
forward).

Skips where there is no CUDA device. On a GPU host without JAX, skip the
JAX-only conftest: `python -m pytest --noconftest -q
tests/test_torch_train_cuda.py`.
"""
import math

import numpy as np
import pytest
import torch

from hypervla_tpu_torch.ops import dino_layer_train as dlt
from hypervla_tpu_torch.ops import fused_attention as fa

pytestmark = pytest.mark.cuda

B, S, H, D = 8, 257, 12, 64
SCALE = 1.0 / math.sqrt(D)


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, device, std=1.0, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=gen) * std).to(device).bfloat16()


def _err(got, ref):
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    return (got - ref).abs().max().item(), ref.abs().max().item()


def test_attention_forward_kernel(device):
    q, k, v = (_randn((B, S, H * D), device, 2.0, seed) for seed in range(3))
    fa.reset_launch_counts()
    o, probs = fa.mha_fused_train_fwd(q, k, v, H, SCALE)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["mha_fused_train_fwd"] == 1
    ref_o, ref_p = fa.mha_fused_train_fwd_reference(q, k, v, H, SCALE)
    for got, ref in ((o, ref_o), (probs, ref_p)):
        err, scale = _err(got, ref)
        # one bf16 ulp of the output scale: fp32 sums in another order
        assert err <= 2 ** -7 * max(scale, 1.0), (err, scale)


def test_attention_forward_strided_qkv(device):
    """q, k, v as column slices of one fused QKV buffer, P store off."""
    qkv = _randn((B, S, 3 * H * D), device, 2.0, seed=4)
    hd = H * D
    q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
    o, probs = fa.mha_fused_train_fwd(q, k, v, H, SCALE, store_p=False)
    torch.cuda.synchronize()
    assert probs is None
    ref, _ = fa.mha_fused_train_fwd_reference(q, k, v, H, SCALE)
    err, scale = _err(o, ref)
    assert err <= 2 ** -7 * max(scale, 1.0), (err, scale)


def test_attention_backward_kernel(device):
    q, k, v, g = (_randn((B, S, H * D), device, 2.0, seed)
                  for seed in range(4))
    _, probs = fa.mha_fused_train_fwd_reference(q, k, v, H, SCALE)
    fa.reset_launch_counts()
    got = fa.mha_fused_train_bwd(q, k, v, probs, g, H, SCALE)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["mha_fused_train_bwd"] == 1
    ref = fa.mha_fused_train_bwd_reference(q, k, v, probs, g, H, SCALE)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        err, scale = _err(a, b)
        # ds is rounded to bf16 between products
        assert err <= 2 ** -5 * max(scale, 1.0), (name, err, scale)


def test_attention_autograd_on_the_card(device):
    leaves = [_randn((2, S, H * D), device, 1.0, seed).requires_grad_(True)
              for seed in range(3)]
    g = _randn((2, S, H * D), device, 1.0, seed=5)
    fa.mha_fused_train(*leaves, H, SCALE).backward(g)
    plain = [t.detach() for t in leaves]
    _, probs = fa.mha_fused_train_fwd_reference(*plain, H, SCALE)
    ref = fa.mha_fused_train_bwd_reference(*plain, probs, g, H, SCALE)
    for leaf, r in zip(leaves, ref):
        err, scale = _err(leaf.grad, r)
        assert err <= 2 ** -5 * max(scale, 1.0), (err, scale)


def test_attention_rejects_other_head_dims(device):
    q = _randn((1, 9, 4 * 32), device)
    with pytest.raises(ValueError, match="heads x 64"):
        fa.mha_fused_train_fwd(q, q, q, 4, SCALE)


def _layer_operands(device, width=768, seed=0):
    rng = np.random.default_rng(seed)

    def t(a, dtype=torch.bfloat16):
        return torch.tensor(np.asarray(a, np.float32)).to(device, dtype)

    weights = [t(rng.standard_normal(s) * 0.02) for s in
               [(width, width)] * 4 + [(width, 4 * width), (4 * width, width)]]
    pv = t(np.concatenate([
        0.02 * rng.standard_normal((5, width)),
        1 + 0.1 * rng.standard_normal((1, width)),
        0.1 * rng.standard_normal((1, width)),
        1 + 0.1 * rng.standard_normal((1, width)),
        0.1 * rng.standard_normal((1, width)),
        0.1 + 0.02 * rng.standard_normal((2, width)),
    ]), torch.float32)
    b1 = t(0.02 * rng.standard_normal((1, 4 * width)), torch.float32)
    return weights, pv, b1


@pytest.mark.parametrize("layers,bound", [(1, 2 ** -6), (12, 0.05)])
def test_layer_forward_kernel(device, layers, bound):
    x = _randn((B, S, 768), device, 0.5)
    ops = [_layer_operands(device, seed=i) for i in range(layers)]
    dlt.reset_launch_counts()
    got, ref = x, x
    for weights, pv, b1 in ops:
        got = dlt.dino_layer_train(got, *weights, pv, b1, H, 1e-6)
        ref = dlt.dino_layer_train_reference(ref, *weights, pv, b1, H, 1e-6)
    torch.cuda.synchronize()
    assert dlt.LAUNCHES["dino_layer_train_fwd"] == layers
    err, scale = _err(got, ref)
    assert err <= bound * max(scale, 1.0), (err, scale)
