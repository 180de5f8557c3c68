"""The port's CUDA trunk kernels against their plain PyTorch versions, on
the card, at the flagship's shapes (dinov2-base: seq 257, width 768).

Skips where there is no CUDA device. On a GPU host without JAX, skip the
JAX-only conftest: `python -m pytest --noconftest -q
tests/test_torch_dino_layer_cuda.py`.
"""
import numpy as np
import pytest
import torch

from hypervla_tpu_torch.ops import dino_layer as dl

pytestmark = pytest.mark.cuda

SEQ, HIDDEN = 257, 768


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _trunk_inputs(layers, device, seed=0):
    rng = np.random.default_rng(seed)

    def t(a, dtype=torch.float32):
        return torch.tensor(a.astype(np.float32), dtype=dtype, device=device)

    x = t(rng.standard_normal((SEQ, HIDDEN)) * 0.5, torch.bfloat16)
    w = t(rng.standard_normal((layers, 3, HIDDEN, 4 * HIDDEN)) * 0.02,
          torch.bfloat16)
    b = t(rng.standard_normal((layers, 3, 4 * HIDDEN)) * 0.02)
    p = np.concatenate([
        1 + 0.1 * rng.standard_normal((layers, 1, HIDDEN)),
        0.1 * rng.standard_normal((layers, 1, HIDDEN)),
        1 + 0.1 * rng.standard_normal((layers, 1, HIDDEN)),
        0.1 * rng.standard_normal((layers, 1, HIDDEN)),
        0.1 + 0.02 * rng.standard_normal((layers, 2, HIDDEN)),
    ], axis=1)
    return x, w, b, t(p)


def _err(got, ref):
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    return (got - ref).abs().max().item(), ref.abs().max().item()


def test_layer_norm_kernel(device):
    x, _, _, p = _trunk_inputs(1, device)
    got = dl.layer_norm_rows(x, p[0, 0], p[0, 1], 1e-6)
    torch.cuda.synchronize()
    err, scale = _err(got, dl.layer_norm_rows_reference(x, p[0, 0], p[0, 1],
                                                        1e-6))
    # one bf16 ulp where the fp32 statistics round differently
    assert err <= 2 ** -7 * max(scale, 1.0), (err, scale)


@pytest.mark.parametrize("which", ["qkv", "out_proj", "fc1", "fc2"])
def test_gemm_kernel(device, which):
    x, w, b, p = _trunk_inputs(1, device)
    h = HIDDEN
    a_wide = (torch.randn(SEQ, 4 * h, device=device) * 0.5).bfloat16()
    cases = {
        "qkv": (x, w[0, 0, :, :3 * h], b[0, 0, :3 * h], "none", {}),
        "out_proj": (x, w[0, 0, :, 3 * h:], b[0, 0, 3 * h:], "residual",
                     dict(residual=x, layer_scale=p[0, dl.LS1])),
        "fc1": (x, w[0, 1], b[0, 1], "gelu", {}),
        "fc2": (a_wide, w[0, 2], b[0, 2, :h], "residual",
                dict(residual=x, layer_scale=p[0, dl.LS2],
                     transpose_w=True)),
    }
    a, wt, bias, epi, kw = cases[which]
    got = dl.gemm(a, wt, bias, epi, **kw)
    torch.cuda.synchronize()
    ref = dl.gemm_reference(a, wt, bias, epi, **kw)
    err, scale = _err(got, ref)
    # fp32 sums in another order: at most one bf16 ulp after rounding
    assert err <= 2 ** -7 * max(scale, 1.0), (which, err, scale)


def test_attention_kernel(device):
    qkv = (torch.randn(SEQ, 3 * HIDDEN, device=device) * 2.0).bfloat16()
    got = dl.attention(qkv)
    torch.cuda.synchronize()
    err, scale = _err(got, dl.attention_reference(qkv))
    assert err <= 2 ** -7 * max(scale, 1.0), (err, scale)


@pytest.mark.parametrize("layers,bound", [(1, 0.01), (12, 0.05)])
def test_trunk_kernel(device, layers, bound):
    x, w, b, p = _trunk_inputs(layers, device)
    dl.reset_launch_counts()
    got = dl.dino_layers_serving(x, w, b, p)
    torch.cuda.synchronize()
    assert dl.LAUNCHES["dino_layers_serving"] == 1
    assert dl.LAUNCHES["dino_gemm"] == 4 * layers
    err, scale = _err(got, dl.dino_layers_serving_reference(x, w, b, p))
    # the bounds JAX holds between its own trunks
    # (tests/test_dino_layer_kernel.py: 0.01 at 2 layers, 0.05 at 12)
    assert err < bound * max(scale, 1.0), (err, scale)
