"""The fused exact-GELU forward (counterpart of hypervla_tpu/ops/gelu.py).

The Pallas TPU kernel `_gelu_kernel` becomes csrc/row_kernels.cu's
`row_gelu`: read the pre-activation, evaluate 0.5 * x * erfc(-x / sqrt 2)
in fp32, round once, write in the input's type. The TPU kernel evaluates erf
by a rational polynomial because its compiler lowers no erf; that form
cancels in 1 + erf(t) for negative t, so the CUDA kernel evaluates erfc
itself by a Chebyshev fit on the fast reciprocal and exp2 (see the note in
the source), within one bf16 ulp of the plain version's torch.erfc at every
finite bf16 input.

Beside the kernel is its plain PyTorch version. The wrapper takes it only
for a tensor on the CPU; for a CUDA tensor it launches the kernel or
raises. Each launch adds one to `LAUNCHES["gelu_exact_fused"]`.
"""
import math
from typing import Dict

import torch

from hypervla_tpu_torch.ops.dino_layer import (
    _check,
    _raise_on_error,
    _route,
    _stream,
)
from hypervla_tpu_torch.ops.layer_norm import row_lib

#: launches of the wrapper since the last reset
LAUNCHES: Dict[str, int] = {"gelu_exact_fused": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def gelu_exact_reference(x):
    """Plain PyTorch exact GELU: fp32 inside, one rounding to x.dtype."""
    xf = x.float()
    return (0.5 * xf * torch.erfc(-xf * math.sqrt(0.5))).to(x.dtype)


def gelu_exact_fused(x):
    """Elementwise exact GELU over any shape, bf16 or fp32; fp32 inside, one
    rounding. Forward only (models/encoders/dinov2.py::GeluExact holds the
    backward)."""
    if _route(x) == "cpu":
        return gelu_exact_reference(x)
    _check(x.dtype in (torch.bfloat16, torch.float32),
           f"x must be bf16 or fp32, got {x.dtype}")
    x = x.contiguous()
    out = torch.empty_like(x)
    aligned = x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    code = row_lib().row_gelu(x.data_ptr(), out.data_ptr(), x.numel(),
                              int(aligned), int(x.dtype == torch.float32),
                              _stream())
    _raise_on_error("row_gelu", code)
    LAUNCHES["gelu_exact_fused"] += 1
    return out
