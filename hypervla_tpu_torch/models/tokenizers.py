"""The discrete action head's tokenizer (counterpart of
hypervla_tpu/models/tokenizers.py::BinTokenizer): each value to one of
n_bins tokens, by bin edges spaced evenly on [low, high] ("uniform") or at
equal-mass quantiles of a standard normal ("normal").

The edges are the JAX package's fp32 ones: jnp.linspace's formula
(start * (1 - step) + stop * step, step = iota / div, the last edge the
stop itself) in fp32, and for "normal" the standard normal's quantile
function of those points, here scipy's (float64, rounded to fp32).
"""
import numpy as np
import torch

EPS = 1e-6


def linspace_fp32(start: float, stop: float, num: int) -> torch.Tensor:
    """jnp.linspace(start, stop, num) in fp32, by jax's own formula."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float32) / div
    start_t = torch.tensor(start, dtype=torch.float32)
    stop_t = torch.tensor(stop, dtype=torch.float32)
    out = start_t * (1 - step) + stop_t * step
    return torch.cat([out, stop_t[None]])


class BinTokenizer:
    def __init__(self, bin_type: str = "uniform", n_bins: int = 256,
                 low: float = -1.0, high: float = 1.0):
        self.bin_type = bin_type
        self.n_bins = n_bins
        self.low = low
        self.high = high
        if bin_type == "uniform":
            edges = linspace_fp32(low, high, n_bins + 1)
        elif bin_type == "normal":
            from scipy.stats import norm

            points = linspace_fp32(EPS, 1 - EPS, n_bins + 1).numpy()
            edges = torch.from_numpy(
                norm.ppf(points.astype(np.float64)).astype(np.float32))
        else:
            raise ValueError(f"Binning type {bin_type} not supported.")
        #: (n_bins + 1,) fp32 edges on the host; each call moves them to
        #: its input's device
        self.thresholds = edges
        self._on = {}

    def _edges(self, device) -> torch.Tensor:
        key = str(device)
        if key not in self._on:
            self._on[key] = self.thresholds.to(device)
        return self._on[key]

    def __call__(self, inputs) -> torch.Tensor:
        """Values -> int32 tokens: the interior edge search with
        side="right" (a value on an edge takes the bin above it), and a
        value outside [edges[0], edges[-1]) token 0; uniform bins clip to
        [low + EPS, high - EPS] first."""
        edges = self._edges(inputs.device)
        if self.bin_type == "uniform":
            inputs = torch.clamp(inputs, self.low + EPS, self.high - EPS)
        token = torch.searchsorted(edges[1:-1], inputs.contiguous(),
                                   right=True)
        in_range = (inputs >= edges[0]) & (inputs < edges[-1])
        return torch.where(in_range, token, 0).to(torch.int32)

    def decode(self, tokens) -> torch.Tensor:
        """Tokens -> the centres of their bins."""
        edges = self._edges(tokens.device)
        centers = (edges[1:] + edges[:-1]) / 2
        return centers[tokens.long()]
