"""What surrounds the redesigned column sum and exact GELU and can run
without the card: the column-sum kernel's grid as a pure function of the
shape (ops/dino_layer_train.py::colsum_config); numpy emulations of the
order in which it and the finishing launch of every column sum add
(csrc/layer_backward.cu: lanes, warps in order, blocks, then the split
finishing launch) against the plain version and fp64; the GELU kernel's
erfc form (csrc/gelu_fit.cuh::gelu) emulated in fp32 over every
finite bf16 input against the plain version; and the wrappers on CPU
tensors, which take the plain versions. No JAX, seconds."""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from hypervla_tpu_torch.ops import dino_layer as dl
from hypervla_tpu_torch.ops import dino_layer_train as dlt
from hypervla_tpu_torch.ops import gelu as tg
from test_torch_harness import torch_threads  # noqa: F401

_SOURCE = (Path(dlt.__file__).resolve().parent.parent / "csrc"
           / "layer_backward.cu")


def finish_warps() -> int:
    """The finishing launch's warps a column, read from the one place that
    sets it (the C constant that `layer_finish_split()` returns)."""
    found = re.search(r"constexpr int FINISH_WARPS = (\d+);",
                      _SOURCE.read_text())
    assert found, "FINISH_WARPS not found in csrc/layer_backward.cu"
    return int(found.group(1))


def emulated_finish(part):
    """csrc/layer_backward.cu::finish_sums_split_kernel in fp32: warp w adds
    parts w, w + FINISH_WARPS, ... in order, then the warps' sums are added
    in warp order. part (parts, ...) fp32."""
    f = np.float32
    split = finish_warps()
    shares = []
    for w in range(split):
        share = np.zeros(part.shape[1:], f)
        for p in range(w, part.shape[0], split):
            share = share + part[p]
        shares.append(share)
    out = shares[0]
    for share in shares[1:]:
        out = out + share
    return out


def emulated_colsum_parts(a, config):
    """csrc/layer_backward.cu::colsum_kernel in fp32: part p owns rows [p
    rows / parts, (p + 1) rows / parts); warp w of the block adds rows r0 +
    w, r0 + w + warps, ... in order (a lane's 8 columns side by side, so
    every column the same); the block adds its warps' sums in warp order.
    a (rows, cols) fp32 holding bf16 values."""
    rows, cols = a.shape
    part = np.zeros((config.parts, cols), np.float32)
    for p in range(config.parts):
        r0, r1 = p * rows // config.parts, (p + 1) * rows // config.parts
        block = None
        for w in range(config.warps):
            mine = np.zeros(cols, np.float32)
            for r in range(r0 + w, r1, config.warps):
                mine = mine + a[r]
            block = mine if block is None else block + mine
        part[p] = block
    return part


def emulated_colsum(a, config):
    return emulated_finish(emulated_colsum_parts(a, config))


def _bf16_rows(rows, cols, seed, std=0.1):
    rng = np.random.default_rng(seed)
    a = torch.tensor((rng.standard_normal((rows, cols)) * std).astype(
        np.float32)).bfloat16()
    return a, a.float().numpy()


# ----------------------------- the column sum -----------------------------


@pytest.mark.parametrize("rows,cols,config", [
    # the layer's dqkv at B=64: 9 strips x 58 parts fill one wave of four
    # blocks a multiprocessor (522 of 528)
    (64 * 257, 2304, (9, 58, 8)),
    (64 * 257 + 37, 2304, (9, 58, 8)),   # ragged row ranges
    (99, 2304, (9, 1, 8)),               # under two parts' rows
    # the cuda test's shapes
    (68, 128, (1, 1, 8)), (1028, 768, (3, 16, 8)), (300, 3072, (12, 4, 8)),
    (1, 8, (1, 1, 8)), (128, 2304, (9, 2, 8))])
def test_colsum_config_of_the_shapes(rows, cols, config):
    assert dlt.colsum_config(rows, cols) == config


@pytest.mark.parametrize("rows", [1, 63, 64, 65, 99, 1028, 16448, 16485,
                                  70000])
@pytest.mark.parametrize("cols", [8, 128, 768, 2304, 3072, 8192])
def test_colsum_grid_fits_one_wave_and_covers_the_rows(rows, cols):
    c = dlt.colsum_config(rows, cols)
    assert c.strips * 256 >= cols > (c.strips - 1) * 256
    assert 1 <= c.warps <= 8 and c.parts >= 1
    # one wave, and no part under COLSUM_MIN_ROWS rows unless there is one
    assert (c.strips * c.parts <= dl.SMS * dlt.COLSUM_BLOCKS_PER_SM
            or c.parts == 1)
    assert c.parts == 1 or rows // c.parts >= dlt.COLSUM_MIN_ROWS
    bounds = [p * rows // c.parts for p in range(c.parts + 1)]
    assert bounds[0] == 0 and bounds[-1] == rows
    assert all(b - a in (rows // c.parts, -(-rows // c.parts))
               for a, b in zip(bounds, bounds[1:]))


@pytest.mark.parametrize("rows,cols", [(99, 768), (1028, 768), (16485, 768),
                                       (300, 3072), (68, 128), (7, 2304)])
def test_colsum_order_agrees_with_the_plain_version_and_fp64(rows, cols):
    a, a32 = _bf16_rows(rows, cols, rows + cols)
    got = emulated_colsum(a32, dlt.colsum_config(rows, cols))
    ref = dlt.colsum_reference(a).numpy()
    exact = a32.astype(np.float64).sum(0)
    for want in (ref, exact):
        bound = 1e-4 * max(float(np.abs(want).max()), 1.0)
        assert float(np.abs(got - want).max()) <= bound


def test_colsum_parts_are_sums_of_their_row_ranges():
    rows, cols = 1028, 256
    a, a32 = _bf16_rows(rows, cols, 3)
    config = dlt.colsum_config(rows, cols)
    parts = emulated_colsum_parts(a32, config)
    for p in range(config.parts):
        rng = slice(p * rows // config.parts, (p + 1) * rows // config.parts)
        exact = a32[rng].astype(np.float64).sum(0)
        assert np.abs(parts[p] - exact).max() <= 1e-5 * max(
            np.abs(exact).max(), 1.0)


@pytest.mark.parametrize("parts", [1, 7, 8, 9, 129, 514])
def test_split_finishing_order_against_fp64(parts):
    """The finishing launch of every column sum: the LayerNorm backward's
    528 partials, kernels 7 and 8's 514, the LayerScale and GELU passes'
    129, the column sum's tens."""
    rng = np.random.default_rng(parts)
    part = rng.standard_normal((parts, 3, 768)).astype(np.float32)
    got = emulated_finish(part)
    exact = part.astype(np.float64).sum(0)
    assert got.shape == (3, 768)
    assert float(np.abs(got - exact).max()) <= 1e-6 * parts * 4
    if parts <= finish_warps():
        # one part a warp: the warps' sums in warp order are the parts in
        # order
        in_order = part[0].copy()
        for p in range(1, parts):
            in_order = in_order + part[p]
        assert np.array_equal(got, in_order)


def test_finish_warps_is_read_from_the_source():
    assert finish_warps() == 8


@pytest.mark.parametrize("cols", [100, 2304, 3])
def test_colsum_on_the_cpu_is_the_plain_version(cols):
    """Any width on the CPU: the width rule is the kernel's."""
    a, _ = _bf16_rows(37, cols, cols)
    dlt.reset_launch_counts()
    assert torch.equal(dlt.colsum(a), dlt.colsum_reference(a))
    assert dlt.LAUNCHES["layer_colsum"] == 0


# ------------------------------- the GELU -------------------------------

# Numerical Recipes' erfcc coefficients, as csrc/row_kernels.cu evaluates
# them (highest degree first)
_ERFCC = (0.17087277, -0.82215223, 1.48851587, -1.13520398, 0.27886807,
          -0.18628806, 0.09678418, 0.37409196, 1.00002368, -1.26551223)


def _fma(a, b, c):
    """fp32 fmaf: the product exact in fp64, one rounding of the sum (up to
    a double rounding no bf16 output can see)."""
    return (a.double() * b.double() + c).float()


def emulated_erfc_neg(xf, rcp_err=0.0, exp_err=0.0):
    """csrc/gelu_fit.cuh::erfc_neg, erfc(-x / sqrt 2), in fp32; the card's
    rcp.approx and ex2.approx stand in as the exact functions times (1 +
    rcp_err) and (1 + exp_err)."""
    f = np.float32
    z = -xf * f(math.sqrt(0.5))
    a = z.abs()
    t = (1.0 / _fma(torch.full_like(a, 0.5), a, 1.0)) * f(1 + rcp_err)
    p = torch.full_like(t, _ERFCC[0])
    for c in _ERFCC[1:]:
        p = _fma(p, t, c)
    arg = _fma(-a, a, p) * f(1 / math.log(2))
    e = t * (torch.exp2(arg) * f(1 + exp_err))
    return torch.where(z < 0, 2.0 - e, e)


def emulated_gelu(xf, rcp_err=0.0, exp_err=0.0):
    """csrc/gelu_fit.cuh::gelu in fp32, as emulated_erfc_neg."""
    return 0.5 * xf * emulated_erfc_neg(xf, rcp_err, exp_err)


def _every_finite_bf16():
    x = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16)
    return x[torch.isfinite(x.float())]


def bf16_ulps(got, ref):
    """|got - ref| in units of the bf16 spacing at ref (the subnormal
    spacing 2^-133 at and below the smallest normal)."""
    g, r = got.double(), ref.double()
    mag = r.abs().clamp(min=2.0 ** -126)
    ulp = 2.0 ** (torch.floor(torch.log2(mag)) - 7)
    return ((g - r).abs() / ulp).nan_to_num(0.0)


@pytest.mark.parametrize("rcp_err,exp_err", [(0.0, 0.0), (2 ** -21, 2 ** -21),
                                             (-2 ** -21, -2 ** -21),
                                             (2 ** -21, -2 ** -21),
                                             (-2 ** -21, 2 ** -21)])
def test_gelu_erfc_form_within_one_ulp_at_every_bf16_input(rcp_err, exp_err):
    """Every finite bf16 input, with the fast reciprocal and exp2 off by
    several times their documented relative error either way: within one
    bf16 ulp of gelu_exact_reference, and all but a few in a thousand
    outputs the same (0.19% at 2^-21 either way)."""
    x = _every_finite_bf16()
    assert x.numel() == 65536 - 256  # no inf, no NaN
    ref = tg.gelu_exact_reference(x)
    got = emulated_gelu(x.float(), rcp_err, exp_err).bfloat16()
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    ulps = bf16_ulps(got.float(), ref.float())
    assert float(ulps.max()) <= 1.0
    assert float((got != ref).float().mean()) < 5e-3


def test_gelu_erfc_form_in_fp32():
    """fp32 inputs: within 1e-6 of the output scale (the kernel's bound is
    1e-5)."""
    rng = np.random.default_rng(5)
    for std in (1.0, 3.0, 10.0):
        x = torch.tensor((rng.standard_normal(200_000) * std).astype(
            np.float32))
        ref = tg.gelu_exact_reference(x)
        got = emulated_gelu(x)
        assert float((got - ref).abs().max()) <= 1e-6 * max(
            float(ref.abs().max()), 1.0)


def test_gelu_on_the_cpu_is_the_plain_version():
    x = torch.tensor(np.linspace(-6, 6, 1031, dtype=np.float32)).bfloat16()
    tg.reset_launch_counts()
    assert torch.equal(tg.gelu_exact_fused(x), tg.gelu_exact_reference(x))
    assert tg.LAUNCHES["gelu_exact_fused"] == 0
