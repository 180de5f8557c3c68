"""The port's differentiable flash attention (csrc/flash_attention_train.cu:
`mha_flash_trainable_fwd`, `mha_flash_trainable_bwd`) against its plain
PyTorch versions on the card, forward and backward, bf16 and fp32, at
ragged sequences and head dims (the scalar loads at a head dim that is no
multiple of 8, or at inputs that are not 16-byte aligned), and at the
flagship's training and serving shapes; each shape again with every
block at 64 rows (the plan for a card of one multiprocessor), so that the
blocks whose rows fill the warpgroup take `wgmma` at every ragged edge
too; two runs bit for bit; a batch's outputs untouched by the next
batch's non-finite rows; the launches the autograd.Function makes with
and without grad and under remat, and the fp32 route's (every fp32
operand as three bf16 terms on the tensor cores) in each fp32 case.

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
          (1, 40, 2, 20), (2, 16, 3, 64), (1, 63, 2, 64), (1, 264, 2, 64),
          (1, 272, 2, 32), (1, 513, 2, 128), (1, 257, 12, 64)]


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


def _match_plain(q, k, v, g, dtype):
    """Forward and backward against the plain versions, and again bit for
    bit; fp32 inputs take the plan's fp32 route."""
    batch, seq, heads, d = q.shape
    plan = ft.flash_train_plan(batch * heads, seq, d, dtype, ft.SMS)
    assert plan.route == ("fp32_split" if dtype == torch.float32 else "bf16")
    ft.reset_launch_counts()
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
    again = (*ft.mha_flash_trainable_fwd(q, k, v),
             *ft.mha_flash_trainable_bwd(q, k, v, g, m, n))
    assert all(torch.equal(a, b) for a, b in zip((o, m, n, *grads), again))
    f32 = int(dtype == torch.float32)
    assert ft.LAUNCHES == dict.fromkeys(ft.LAUNCHES, 2)
    assert ft.FP32_LAUNCHES == dict.fromkeys(ft.LAUNCHES, 2 * f32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_forward_and_backward_match_plain(device, shape, dtype):
    dtype = DTYPES[dtype]
    _match_plain(*_inputs(shape, dtype, device), dtype)


@pytest.fixture
def full_blocks(monkeypatch):
    """Plans for a card of one multiprocessor: every block takes 64 rows."""
    monkeypatch.setattr(ft, "SMS", 1)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_full_blocks_match_plain(device, full_blocks, shape, dtype):
    dtype = DTYPES[dtype]
    _match_plain(*_inputs(shape, dtype, device), dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_unaligned_inputs_match_plain(device, dtype):
    """Inputs one value past a 16-byte boundary: the plain loads."""
    dtype = DTYPES[dtype]
    shape = (2, 70, 3, 64)
    views = []
    for t in _inputs(shape, dtype, device, seed=3):
        flat = torch.empty(t.numel() + 8, dtype=dtype, device=device)
        view = flat[1:1 + t.numel()].view(shape)
        view.copy_(t)
        assert view.data_ptr() % 16 != 0
        views.append(view)
    _match_plain(*views, dtype)


@pytest.mark.parametrize("blocks", ["plan", "full"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_two_runs_repeat_bit_for_bit(device, monkeypatch, dtype, blocks):
    dtype = DTYPES[dtype]
    if blocks == "full":
        monkeypatch.setattr(ft, "SMS", 1)
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


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("blocks", ["plan", "full"])
@pytest.mark.parametrize("head_dim", [64, 128])
def test_a_batch_never_reads_the_next(device, monkeypatch, head_dim,
                                      blocks, dtype):
    """A batch's outputs do not depend on the next batch's rows, not even
    where they are not finite: the ring's copies (TMA at these head dims;
    in fp32 from the terms' scratch, a slab per head and term) stop at S.
    Batch 0's o, m, n, dq, dk, dv with batch 1 all Inf and NaN are those
    with batch 1 finite, bit for bit."""
    if blocks == "full":
        monkeypatch.setattr(ft, "SMS", 1)
    clean = _inputs((2, 257, 4, head_dim), DTYPES[dtype], device, seed=4)
    poisoned = [t.clone() for t in clean]
    for i, t in enumerate(poisoned):
        t[1] = float("nan") if i % 2 else float("inf")

    def outs(q, k, v, g):
        o, m, n = ft.mha_flash_trainable_fwd(q, k, v)
        return (o, m, n, *ft.mha_flash_trainable_bwd(q, k, v, g, m, n))

    for name, a, b in zip(("o", "m", "n", "dq", "dk", "dv"), outs(*clean),
                          outs(*poisoned)):
        assert torch.isfinite(a[0]).all() and torch.equal(a[0], b[0]), name


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
    # fp32 leaves: the same launches, on the fp32 route
    leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
    ft.mha_flash_trainable(*leaves).backward(g.float())
    assert ft.LAUNCHES == ft.FP32_LAUNCHES == {
        "mha_flash_trainable_fwd": 1, "mha_flash_trainable_bwd": 1}
