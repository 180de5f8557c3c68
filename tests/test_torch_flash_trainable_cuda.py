"""The port's differentiable flash attention (csrc/flash_attention_train.cu:
`mha_flash_trainable_fwd`, `mha_flash_trainable_bwd`) against its plain
PyTorch versions on the card, forward and backward, bf16 and fp32, at
ragged sequences and head dims (the scalar loads at a head dim that is no
multiple of 8), and at the flagship's training shape; two runs bit for
bit; the launches the autograd.Function makes with and without grad and
under remat.

Skips where there is no CUDA device. On a GPU host without JAX, skip the
JAX-only conftest: `python -m pytest --noconftest -q
tests/test_torch_flash_trainable_cuda.py`.

Bounds: one bf16 ulp at the output's scale (2^-7 of its largest value,
or of 1 where that is smaller: the inputs are of unit scale, and at one
key dq and dk are 0 up to rounding) for bf16, 1e-5 of it for fp32. The
kernels sum in another order than cuBLAS, so an fp32 score or dp at a
bf16 rounding midpoint may round the other way (ROADMAP.md's kernel
note); the row max is a maximum of the same scores, the row sum within
1e-5.
"""
import numpy as np
import pytest
import torch

from hypervla_tpu_torch.ops import flash_attention_train as ft
from test_torch_harness import torch_threads  # noqa: F401

pytestmark = pytest.mark.cuda

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
#: (batch, seq, heads, head_dim)
SHAPES = [(2, 1, 3, 64), (2, 17, 3, 16), (2, 33, 2, 32), (1, 64, 2, 64),
          (2, 65, 3, 128), (1, 300, 2, 64), (2, 257, 12, 64),
          (1, 40, 2, 20)]


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(shape).astype(np.float32),
                         dtype=dtype, device=device) for _ in range(4)]


def close(got, ref, dtype, what=""):
    got, ref = got.float(), ref.float()
    assert got.shape == ref.shape and torch.isfinite(got).all(), what
    err = (got - ref).abs().max().item()
    tol = (2 ** -7 if dtype == torch.bfloat16 else 1e-5) * max(
        ref.abs().max().item(), 1.0)
    assert err <= tol, (what, err, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_forward_and_backward_match_plain(device, shape, dtype):
    dtype = DTYPES[dtype]
    q, k, v, g = _inputs(shape, dtype, device)
    o, m, n = ft.mha_flash_trainable_fwd(q, k, v)
    ro, rm, rn = ft.mha_flash_trainable_fwd_reference(q, k, v)
    torch.cuda.synchronize()
    close(o, ro, dtype, "o")
    close(m, rm, torch.float32, "m")
    close(n, rn, torch.float32, "n")
    grads = ft.mha_flash_trainable_bwd(q, k, v, g, m, n)
    refs = ft.mha_flash_trainable_bwd_reference(q, k, v, g, m, n)
    torch.cuda.synchronize()
    for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        assert got.dtype == dtype
        close(got, ref, dtype, name)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_two_runs_repeat_bit_for_bit(device, dtype):
    dtype = DTYPES[dtype]
    q, k, v, g = _inputs((2, 257, 12, 64), dtype, device, seed=1)
    first = ft.mha_flash_trainable_fwd(q, k, v)
    again = ft.mha_flash_trainable_fwd(q, k, v)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    _, m, n = first
    grads = ft.mha_flash_trainable_bwd(q, k, v, g, m, n)
    grads_again = ft.mha_flash_trainable_bwd(q, k, v, g, m, n)
    for a, b in zip(grads, grads_again):
        assert torch.equal(a, b)


def test_launches_with_and_without_grad_and_under_remat(device):
    q, k, v, g = _inputs((2, 17, 3, 64), torch.bfloat16, device, seed=2)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ft.reset_launch_counts()
    ft.mha_flash_trainable(*leaves).backward(g)
    assert ft.LAUNCHES == {"mha_flash_trainable_fwd": 1,
                           "mha_flash_trainable_bwd": 1}
    ft.reset_launch_counts()
    with torch.no_grad():
        ft.mha_flash_trainable(q, k, v)
    assert ft.LAUNCHES == {"mha_flash_trainable_fwd": 1,
                           "mha_flash_trainable_bwd": 0}
    ft.reset_launch_counts()
    out = torch.utils.checkpoint.checkpoint(
        ft.mha_flash_trainable, *leaves, use_reentrant=False)
    out.backward(g)
    assert ft.LAUNCHES == {"mha_flash_trainable_fwd": 2,
                           "mha_flash_trainable_bwd": 1}
    # the plain twin launches nothing, on the card too
    ft.reset_launch_counts()
    ft.mha_flash_trainable_reference(*leaves).backward(g)
    assert set(ft.LAUNCHES.values()) == {0}
