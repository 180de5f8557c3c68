"""Multi-head attention (counterpart of hypervla_tpu/models/attention.py).

Params follow flax's MultiHeadDotProductAttention layout: query/key/value
kernels (in, heads, head_dim) with biases (heads, head_dim), and an `out`
kernel (heads, head_dim, out). The non-differential path only; the
differential attention variant is not ported yet (ROADMAP.md, queue A3).
"""
import math
from typing import Dict, Optional, Tuple

import torch

from hypervla_tpu_torch.models import layers


def dot_product_attention_weights(query, key, mask: Optional[torch.Tensor]):
    """softmax(Q K^T / sqrt(d)) with a boolean mask (True = attend).
    query (..., q, h, d), key (..., k, h, d) -> (..., h, q, k)."""
    query = query / math.sqrt(query.shape[-1])
    weights = torch.einsum("...qhd,...khd->...hqk", query, key)
    if mask is not None:
        weights = torch.where(mask, weights, torch.finfo(weights.dtype).min)
    return torch.softmax(weights, dim=-1)


def multi_head_attention(params: Dict[str, torch.Tensor], prefix: str,
                         inputs_q, inputs_kv, mask, num_heads: int):
    """Self or cross attention; `prefix` names the module's param subtree.
    The params may carry a leading per-sample axis in the broadcast layout
    of models/hypernetwork.py::per_sample_view."""
    def proj(name, x):
        kernel = params[f"{prefix}/{name}/kernel"]  # ([B,] in, h, d)
        y = x @ kernel.flatten(-2)
        y = y + params[f"{prefix}/{name}/bias"].flatten(-2)
        return y.reshape(*x.shape[:-1], *kernel.shape[-2:])

    q, k, v = proj("query", inputs_q), proj("key", inputs_kv), \
        proj("value", inputs_kv)
    weights = dot_product_attention_weights(q, k, mask)
    x = torch.einsum("...hqk,...khd->...qhd", weights, v)
    out = params[f"{prefix}/out/kernel"]  # ([B,] h, d, out)
    return layers.dense(x.reshape(*x.shape[:-2], -1), out.flatten(-3, -2),
                        params[f"{prefix}/out/bias"])


def multi_head_attention_specs(prefix: str, features: int, num_heads: int
                               ) -> Dict[str, Tuple[tuple, layers.Init]]:
    """Param shapes and initializers (flax MHA: xavier-uniform kernels over
    the flattened 2-D shape, zero biases)."""
    head_dim = features // num_heads
    specs = {}
    for name in ("key", "query", "value"):
        specs[f"{prefix}/{name}/kernel"] = (
            (features, num_heads, head_dim),
            layers.xavier_uniform((features, features)),
        )
        specs[f"{prefix}/{name}/bias"] = ((num_heads, head_dim), layers.zeros)
    specs[f"{prefix}/out/kernel"] = (
        (num_heads, head_dim, features),
        layers.xavier_uniform((features, features)),
    )
    specs[f"{prefix}/out/bias"] = ((features,), layers.zeros)
    return specs
