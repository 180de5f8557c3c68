"""What surrounds the redesigned Hopper kernels and can run without the
card: the device the entry points build on, the GEMM kernel's tile chooser
over every shape the port launches, and the padded row stride of the
attention probabilities (the plain versions through a padded view, the
layer backward's checks, and the wrapper against the JAX package's Pallas
`mha_fused_train` in interpret mode)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervla_tpu.ops import fused_attention as jfa
from hypervla_tpu_torch.configs import tiny_test_config
from hypervla_tpu_torch.flagship import build_flagship, make_flagship_batch
from hypervla_tpu_torch.models.hypervla import HyperVLA
from hypervla_tpu_torch.ops import dino_layer as dl
from hypervla_tpu_torch.ops import dino_layer_train as dlt
from hypervla_tpu_torch.ops import fused_attention as tfa
from hypervla_tpu_torch.train.trainer import build_frozen_encoders
from hypervla_tpu_torch.utils.device import resolve_device

# ------------------------------ the device ------------------------------


def _tiny_batch():
    return make_flagship_batch(instr_len=8, action_horizon=2,
                               initial_patch_dim=32)


ENTRY_POINTS = {
    "build_flagship": lambda **kw: build_flagship(tiny=True, **kw)[0],
    "from_config": lambda **kw: HyperVLA.from_config(
        tiny_test_config(), _tiny_batch(), **kw),
    "build_frozen_encoders": lambda **kw: build_frozen_encoders(
        tiny_test_config(), **kw),
}


def test_resolve_device_names_the_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")


def test_resolve_device_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None).type == "cuda"


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_builds_on_the_cpu_when_asked(name):
    built = ENTRY_POINTS[name](device="cpu")
    if name == "build_frozen_encoders":
        t5_params = built[2]
        assert all(v.device.type == "cpu" for v in t5_params.values())
    else:
        assert built.device == torch.device("cpu")
        assert all(v.device.type == "cpu" for v in built.params.values())


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_a_card_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ENTRY_POINTS[name]()


# ------------------------- the GEMM's tile chooser -------------------------

HIDDEN = 768
# (N, K) of the layer's four forward products and of their dX transposes
LAYER_NK = [(3 * HIDDEN, HIDDEN), (HIDDEN, HIDDEN), (4 * HIDDEN, HIDDEN),
            (HIDDEN, 4 * HIDDEN), (HIDDEN, 3 * HIDDEN)]
GEMM_SHAPES = (
    [(257, n, k) for n, k in LAYER_NK[:4]]            # the serving trunk
    + [(64 * 257, n, k) for n, k in LAYER_NK]         # the training layer
    + [(m, n, k) for m in (1, 63, 64, 65) for n, k in LAYER_NK[:2]]
    + [(2 * 17, 3 * 64, 64), (2 * 17, 64, 4 * 64), (600, 64, 96),
       (600, 192, 32), (600, 384, 128), (1028, 512, 128)]  # the tests' widths
)


@pytest.mark.parametrize("m,n,k", GEMM_SHAPES)
def test_gemm_config_fits_the_kernel(m, n, k):
    cfg = dl.gemm_config(m, n, k)
    assert (cfg.block_m, cfg.block_n) in ((128, 256), (64, 64))
    assert (cfg.block_m == 64) == (m <= 512 or n % 256 != 0)
    assert n % cfg.block_n == 0
    k_tiles = -(-k // dl.GEMM_BLOCK_K)
    assert cfg.split_k >= 1 and k_tiles % cfg.split_k == 0
    if cfg.split_k > 1:
        # only the small tile splits, only where the grid is short of the
        # card and every part keeps a pipeline's worth of k-tiles
        assert cfg.block_m == 64
        assert k_tiles // cfg.split_k >= 4
        blocks = -(-m // 64) * (n // 64)
        assert blocks * cfg.split_k // 2 < dl.GEMM_SMS


def test_gemm_config_of_the_flagship_shapes():
    for n, k in LAYER_NK:
        assert dl.gemm_config(64 * 257, n, k) == (128, 256, 1)
    assert dl.gemm_config(64 * 257, 128, HIDDEN) == (64, 64, 1)
    assert dl.gemm_config(257, 3 * HIDDEN, HIDDEN) == (64, 64, 1)
    assert dl.gemm_config(257, HIDDEN, HIDDEN) == (64, 64, 2)
    assert dl.gemm_config(257, HIDDEN, 4 * HIDDEN) == (64, 64, 4)
    # a large M whose N is no multiple of 256 keeps the small tile, unsplit
    assert dl.gemm_config(64 * 257, 192, HIDDEN) == (64, 64, 1)


# ------------------- the probabilities' padded row stride -------------------

S, H, D = 33, 4, 64
SCALE = 1.0 / np.sqrt(D)


def _inputs(batch, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((batch, S, H * D)).astype(np.float32)
            for _ in range(4)]
    jx = [jnp.asarray(a, jnp.bfloat16) for a in arrs]
    tx = [torch.tensor(np.asarray(a.astype(jnp.float32))).bfloat16()
          for a in jx]
    return jx, tx


@pytest.mark.parametrize("seq,stride", [(1, 8), (8, 8), (33, 40), (256, 256),
                                        (257, 264)])
def test_probs_row_stride(seq, stride):
    assert tfa.probs_row_stride(seq) == stride


def test_padded_probs_is_a_view_with_zero_pad():
    _, (tq, tk, tv, _) = _inputs(2)
    _, dense = tfa.mha_fused_train_fwd_reference(tq, tk, tv, H, SCALE)
    assert not tfa._is_padded_probs(dense)
    padded = tfa.padded_probs(dense)
    sp = tfa.probs_row_stride(S)
    assert padded.shape == dense.shape and torch.equal(padded, dense)
    assert padded.stride() == (H * S * sp, S * sp, sp, 1)
    assert tfa._is_padded_probs(padded)
    assert tfa.padded_probs(padded) is padded
    whole = torch.as_strided(padded, (2, H, S, sp), padded.stride())
    assert not whole[..., S:].any()
    # a batch slice of the padded view is still one
    assert tfa._is_padded_probs(padded[1:])


def test_plain_versions_agree_through_a_padded_view():
    _, (tq, tk, tv, tg) = _inputs(3, seed=1)
    _, dense = tfa.mha_fused_train_fwd_reference(tq, tk, tv, H, SCALE)
    padded = tfa.padded_probs(dense)
    ref = tfa.mha_fused_train_bwd_reference(tq, tk, tv, dense, tg, H, SCALE)
    got = tfa.mha_fused_train_bwd(tq, tk, tv, padded, tg, H, SCALE)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("batch", [2, 3])
def test_backward_through_a_padded_view_matches_pallas_vjp(batch):
    (q, k, v, g), (tq, tk, tv, tg) = _inputs(batch, seed=2)
    _, vjp = jax.vjp(lambda q, k, v: jfa.mha_fused_train(q, k, v, H, SCALE),
                     q, k, v)
    refs = vjp(g)
    _, probs = tfa.mha_fused_train_fwd(tq, tk, tv, H, SCALE)
    got = tfa.mha_fused_train_bwd(tq, tk, tv, tfa.padded_probs(probs), tg, H,
                                  SCALE)
    for name, ref, grad in zip("qkv", refs, got):
        ref = np.asarray(ref, np.float32)
        # the bound tests/test_torch_fused_attention.py holds: ds is
        # rounded to bf16 before two more products
        bound = 2 ** -6 * max(np.abs(ref).max(), 1.0)
        assert np.abs(grad.float().numpy() - ref).max() <= bound, name


def test_layer_backward_takes_the_padded_probs():
    """The layer's residual checks accept P as the attention forward
    returns it on the card, and the backward's values do not change."""
    rng = np.random.default_rng(3)
    b, s, h, heads = 2, 9, 128, 2

    def t(shape, scale, dtype=torch.bfloat16):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32)
                            * scale).to(dtype)

    weights = [t(shape, 0.05) for shape in
               [(h, h)] * 4 + [(h, 4 * h), (4 * h, h)]]
    pv = t((11, h), 0.1, torch.float32)
    pv[5] += 1.0
    pv[7] += 1.0
    ops = dlt.pack_operands(*weights, pv, t((1, 4 * h), 0.05, torch.float32))
    x, g = t((b, s, h), 0.5), t((b, s, h), 1.0)
    _, res = dlt.forward_with_residuals(x, ops, heads, 1e-6)
    ref = dlt.layer_backward(g, x, ops, res, heads, 1e-6)
    res = list(res)
    res[2] = tfa.padded_probs(res[2])
    assert not res[2].is_contiguous()
    got = dlt.layer_backward(g, x, ops, res, heads, 1e-6)
    for a, b_ in zip(got, ref):
        assert torch.equal(a, b_)
