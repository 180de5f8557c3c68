"""What surrounds the redesigned Hopper kernels and can run without the
card: the device the entry points build on, the GEMM kernel's tile chooser
over every shape the port launches, the tile and row split of the layer
backward's weight gradients, the two identities the tensor-core flash
attention rests on (P as three bf16 terms, the score scaled by a power of
two), and the padded row stride of the attention probabilities (the plain versions through a padded view, the
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
from hypervla_tpu_torch.ops import flash_attention as tfl
from hypervla_tpu_torch.ops import fused_attention as tfa
from hypervla_tpu_torch.train.trainer import build_frozen_encoders
from hypervla_tpu_torch.utils.device import resolve_device
from test_torch_harness import torch_threads  # noqa: F401

# ------------------------------ the device ------------------------------


def _tiny_batch():
    return make_flagship_batch(instr_len=8, action_horizon=2,
                               initial_patch_dim=32)


ENTRY_POINTS = {
    "build_flagship": lambda **kw: build_flagship(
        tiny=True, encoder_dtype="bfloat16", **kw)[0],
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
    """... and turns cuDNN's TF32 convolutions off there, not on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert resolve_device("cpu").type == "cpu"
    assert torch.backends.cudnn.allow_tf32
    assert resolve_device(None).type == "cuda"
    assert not torch.backends.cudnn.allow_tf32


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


# ---------------- the weight gradients' tile and row split ----------------

# (M, K1, N) of the flagship layer's four weight gradients
FLAGSHIP_TN = {"dW2": (64 * 257, 4 * HIDDEN, HIDDEN),
               "dW1": (64 * 257, HIDDEN, 4 * HIDDEN),
               "dWo": (64 * 257, HIDDEN, HIDDEN),
               "dWqkv": (64 * 257, HIDDEN, 3 * HIDDEN)}
GEMM_TN_SHAPES = list(FLAGSHIP_TN.values()) + [
    (64 * 257 + 37, HIDDEN, HIDDEN), (64 * 257 - 27, HIDDEN, 3 * HIDDEN),
    (68, 128, 384), (99, 512, 128), (1028, HIDDEN, HIDDEN), (1028, 128, 384),
    (2100, 256, 512), (1, 64, 64), (2 * 17, 64, 4 * 64)]  # the tests' shapes


@pytest.mark.parametrize("m,k1,n", GEMM_TN_SHAPES)
def test_gemm_tn_config_fits_the_kernel(m, k1, n):
    cfg = dlt.gemm_tn_config(m, k1, n)
    assert cfg == dlt.gemm_tn_config(m, k1, n)  # the shape alone decides
    assert (cfg.block_m, cfg.block_n) in ((128, 256), (64, 64))
    assert k1 % cfg.block_m == 0 and n % cfg.block_n == 0
    large = m > 512 and k1 % 128 == 0 and n % 256 == 0
    assert (cfg.block_n == 256) == large
    # the parts cover the row tiles, each once, none empty, each at least a
    # ring deep where the rows are split at all
    row_tiles = -(-m // 64)
    assert 1 <= cfg.split <= row_tiles
    cuts = [s * row_tiles // cfg.split for s in range(cfg.split + 1)]
    parts = [b - a for a, b in zip(cuts, cuts[1:])]
    assert cuts[0] == 0 and cuts[-1] == row_tiles and min(parts) >= 1
    if cfg.split > 1:
        assert min(parts) >= dlt.GEMM_TN_MIN_ROW_TILES
    # one 128 x 256 block a multiprocessor (196 KB of ring), three 64 x 64
    assert dlt.gemm_tn_blocks_per_wave(cfg) == dl.GEMM_SMS * (
        1 if large else 3)
    # no other split of the same tile is cheaper by the model
    cost = dlt.gemm_tn_cost_us(m, k1, n, cfg)
    for split in range(1, max(1, row_tiles // dlt.GEMM_TN_MIN_ROW_TILES) + 1):
        assert cost <= dlt.gemm_tn_cost_us(m, k1, n, cfg._replace(split=split))


@pytest.mark.parametrize("name,config", [
    ("dW2", (128, 256, 3)), ("dW1", (128, 256, 3)), ("dWo", (128, 256, 7)),
    ("dWqkv", (128, 256, 2))])
def test_gemm_tn_config_of_the_flagship_shapes(name, config):
    """72, 72, 18 and 54 tiles of 128 x 256 on 132 multiprocessors: dWo is
    split until one wave is nearly full (126 blocks), the others until two
    are (216, 216, 108 blocks), no further than the fp32 partial tiles'
    traffic pays for."""
    cfg = dlt.gemm_tn_config(*FLAGSHIP_TN[name])
    assert cfg == config
    m, k1, n = FLAGSHIP_TN[name]
    blocks = (k1 // 128) * (n // 256) * cfg.split
    assert blocks <= 2 * dlt.gemm_tn_blocks_per_wave(cfg)


def test_gemm_tn_on_the_cpu_is_the_plain_version():
    rng = np.random.default_rng(5)
    a = torch.tensor(rng.standard_normal((99, 128)).astype(np.float32))
    b = torch.tensor(rng.standard_normal((99, 64)).astype(np.float32))
    a, b = a.bfloat16(), b.bfloat16()
    dlt.reset_launch_counts()
    got = dlt.gemm_tn(a, b)
    assert torch.equal(got, dlt.gemm_tn_reference(a, b))
    assert torch.equal(got, dlt.gemm_tn(a, b, dlt.GemmTnConfig(64, 64, 2)))
    assert dlt.LAUNCHES["layer_gemm_tn"] == 0  # no kernel was launched


# ------------- what the tensor-core flash attention rests on -------------


def _probabilities(n, seed):
    """fp32 values in (0, 1] as a softmax makes them: exp(s - max) over a
    wide range of s, and 1 itself."""
    rng = np.random.default_rng(seed)
    p = np.exp(-rng.uniform(0.0, 80.0, n)).astype(np.float32)
    p = p[p >= np.finfo(np.float32).tiny * 2 ** 16]  # normal, terms included
    return torch.tensor(np.concatenate([p, np.ones(1, np.float32)]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_three_bf16_terms_carry_all_of_p(seed):
    p = _probabilities(200000, seed)
    hi, mid, lo = tfl.split_bf16_terms(p)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    # exactly, in any order of the fp32 sum
    assert torch.equal(hi.float() + mid.float() + lo.float(), p)
    assert torch.equal(hi.float() + (mid.float() + lo.float()), p)
    assert torch.equal((hi.double() + mid.double() + lo.double()).float(), p)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_two_bf16_terms_leave_less_than_two_to_the_minus_16(seed):
    p = _probabilities(200000, seed)
    hi, mid, lo = tfl.split_bf16_terms(p)
    residual = (p.double() - hi.double() - mid.double()).abs()
    assert bool((residual <= 2.0 ** -16 * p.double()).all())
    assert torch.equal(residual.float(), lo.float().abs())
    assert bool((lo != 0).any())  # the third term is needed for all of p


@pytest.mark.parametrize("d", [16, 64])
def test_scaled_bf16_q_is_a_bf16_value_for_power_of_four_head_dims(d):
    """1/sqrt(d) is a power of two: q * scale in fp32 is again a bf16 value,
    and (q * scale) . k == (q . k) * scale bit for bit, so the kernel may
    scale the fp32 score where the TPU kernel scales q."""
    rng = np.random.default_rng(d)
    scale = 1.0 / np.sqrt(d)
    assert np.log2(scale) == round(np.log2(scale))
    q = torch.tensor(rng.standard_normal((512, d)).astype(np.float32))
    k = torch.tensor(rng.standard_normal((512, d)).astype(np.float32))
    q, k = q.bfloat16().float(), k.bfloat16().float()
    scaled = q * np.float32(scale)
    assert torch.equal(scaled.bfloat16().float(), scaled)
    # sums of exact products in fp64, rounded once to fp32, either way
    first = (scaled.double() @ k.double().t()).float()
    after = ((q.double() @ k.double().t()).float() * np.float32(scale))
    assert torch.equal(first, after)


@pytest.mark.parametrize("d", [8, 32, 128])
def test_other_head_dims_scale_the_score_within_one_fp32_rounding(d):
    rng = np.random.default_rng(d)
    scale = np.float32(1.0 / np.sqrt(d))
    q = torch.tensor(rng.standard_normal((256, d)).astype(np.float32))
    k = torch.tensor(rng.standard_normal((256, d)).astype(np.float32))
    q, k = q.bfloat16().float(), k.bfloat16().float()
    exact = (q.double() @ k.double().t()) * float(scale)
    after = (q.double() @ k.double().t()).float() * scale
    assert bool(((after.double() - exact).abs()
                 <= 2.0 ** -23 * exact.abs()).all())


@pytest.mark.parametrize("batch_heads,q_len,warps,blocks", [
    (12, 257, 2, 108),      # the per-layer serving step: 9 blocks a head
    (768, 257, 4, 3840),    # batch 64: 5 blocks of 64 rows a head
    (24, 65, 2, 72), (2, 1, 2, 2), (132, 64, 4, 132)])
def test_flash_warps_and_grid(batch_heads, q_len, warps, blocks):
    assert tfl.flash_warps(batch_heads, q_len) == warps
    assert -(-q_len // (16 * warps)) * batch_heads == blocks


def test_mha_flash_on_the_cpu_is_the_plain_version():
    rng = np.random.default_rng(6)
    q, k, v = (torch.tensor(rng.standard_normal((2, 9, 2, 16)).astype(
        np.float32)).bfloat16() for _ in range(3))
    tfl.reset_launch_counts()
    assert torch.equal(tfl.mha_flash(q, k, v),
                       tfl.mha_flash_reference(q, k, v))
    assert tfl.LAUNCHES["flash_attention"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        tfl.mha_flash_fma(q, k, v)


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
