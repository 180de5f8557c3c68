"""Multi-head attention (counterpart of hypervla_tpu/models/attention.py).

Params follow flax's MultiHeadDotProductAttention layout: query/key/value
kernels (in, heads, head_dim) with biases (heads, head_dim), and an `out`
kernel (heads, head_dim, out). The attention weights take the JAX module's
dropout (models/draws.py) at the module's own path.

`differential_attention` is the JAX DifferentialAttention: softmax(Q1
K1^T) - lambda * softmax(Q2 K2^T) over bias-free q/k/v projections,
without the 1/sqrt(d) scale, each head's output RMS-normed ("subln") and
scaled by 1 - lambda_init, then out_proj. Its params (lambda_k1,
lambda_k2, lambda_q1, lambda_q2, k_proj, out_proj, q_proj, subln, v_proj)
keep the flax names.
"""
import math
from typing import Dict, Optional, Tuple

import torch

from hypervla_tpu_torch.models import layers
from hypervla_tpu_torch.models.draws import Draws, attention_dropout


def dot_product_attention_weights(query, key, mask: Optional[torch.Tensor]):
    """softmax(Q K^T / sqrt(d)) with a boolean mask (True = attend).
    query (..., q, h, d), key (..., k, h, d) -> (..., h, q, k)."""
    query = query / math.sqrt(query.shape[-1])
    weights = torch.einsum("...qhd,...khd->...hqk", query, key)
    if mask is not None:
        weights = torch.where(mask, weights, torch.finfo(weights.dtype).min)
    return torch.softmax(weights, dim=-1)


def multi_head_attention(params: Dict[str, torch.Tensor], prefix: str,
                         inputs_q, inputs_kv, mask, num_heads: int,
                         dropout_rate: float = 0.0,
                         draws: Optional[Draws] = None,
                         return_weights: bool = False):
    """Self or cross attention; `prefix` names the module's param subtree
    (and the site of the weights' dropout). The params may carry a leading
    per-sample axis in the broadcast layout of
    models/hypernetwork.py::per_sample_view. return_weights: (output, the
    attention weights after their dropout)."""
    def proj(name, x):
        kernel = params[f"{prefix}/{name}/kernel"]  # ([B,] in, h, d)
        y = x @ kernel.flatten(-2)
        y = y + params[f"{prefix}/{name}/bias"].flatten(-2)
        return y.reshape(*x.shape[:-1], *kernel.shape[-2:])

    q, k, v = proj("query", inputs_q), proj("key", inputs_kv), \
        proj("value", inputs_kv)
    weights = attention_dropout(dot_product_attention_weights(q, k, mask),
                                dropout_rate, draws, prefix)
    x = torch.einsum("...hqk,...khd->...qhd", weights, v)
    out = params[f"{prefix}/out/kernel"]  # ([B,] h, d, out)
    out = layers.dense(x.reshape(*x.shape[:-2], -1), out.flatten(-3, -2),
                       params[f"{prefix}/out/bias"])
    return (out, weights) if return_weights else out


def lambda_init_fn(depth: int) -> float:
    """The Differential Transformer's depth-dependent lambda init."""
    return 0.8 - 0.6 * math.exp(-0.3 * depth)


def rms_norm(x, weight=None, eps: float = 1e-6):
    """The JAX RMSNorm over the last axis: x * rsqrt(mean(x^2) + eps),
    times weight ((dim,), or per sample (B, 1, dim), broadcast over the
    axes between)."""
    normed = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    if weight is None:
        return normed
    return normed * weight.reshape(
        weight.shape[:-1] + (1,) * (x.dim() - weight.dim()) + weight.shape[-1:])


def differential_attention(params: Dict[str, torch.Tensor], prefix: str, x,
                           attn_mask, embed_dim: int, num_heads: int,
                           num_kv_heads: Optional[int] = None,
                           depth: int = 0, eps: float = 1e-5):
    """DifferentialAttention (hypervla_tpu/models/attention.py): x (B, T,
    embed_dim) -> (output (B, T, embed_dim), map (B, heads, T, T)), the
    map a1 - lambda * a2, whose entries can be negative. A bool or integer
    attn_mask (True / nonzero = attend) sets the masked logits to the
    dtype's min; a float one is added to the logits. num_kv_heads <
    num_heads repeats K and V over the heads. The params may carry a
    leading per-sample axis (models/hypernetwork.py::per_sample_view)."""
    kv_heads = num_kv_heads or num_heads
    n_rep = num_heads // kv_heads
    head_dim = embed_dim // (2 * num_heads)
    bsz, seq, _ = x.shape

    def proj(name):
        return x @ params[f"{prefix}/{name}/kernel"]

    q = proj("q_proj").reshape(bsz, seq, num_heads, 2, head_dim)
    k = proj("k_proj").reshape(bsz, seq, kv_heads, 2, head_dim)
    v = proj("v_proj").reshape(bsz, seq, kv_heads, 2 * head_dim)
    q1, q2 = q[..., 0, :], q[..., 1, :]
    k1, k2 = k[..., 0, :], k[..., 1, :]
    if n_rep > 1:
        k1 = k1.repeat_interleave(n_rep, dim=2)
        k2 = k2.repeat_interleave(n_rep, dim=2)
        v = v.repeat_interleave(n_rep, dim=2)
    logits1 = torch.einsum("bthd,bshd->bhts", q1, k1)
    logits2 = torch.einsum("bthd,bshd->bhts", q2, k2)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool or not attn_mask.is_floating_point():
            neg = torch.finfo(logits1.dtype).min
            keep = attn_mask.bool()
            logits1 = torch.where(keep, logits1, neg)
            logits2 = torch.where(keep, logits2, neg)
        else:
            logits1 = logits1 + attn_mask
            logits2 = logits2 + attn_mask
    a1 = torch.softmax(logits1, dim=-1)
    a2 = torch.softmax(logits2, dim=-1)

    def lam(name):
        return params[f"{prefix}/{name}"]

    lambda_init = lambda_init_fn(depth)
    lambda_full = (torch.exp((lam("lambda_q1") * lam("lambda_k1")).sum(-1))
                   - torch.exp((lam("lambda_q2") * lam("lambda_k2")).sum(-1))
                   + lambda_init)
    attn = a1 - lambda_full.reshape(-1, 1, 1, 1) * a2
    out = torch.einsum("bhts,bshd->bthd", attn, v)
    out = rms_norm(out, params[f"{prefix}/subln/weight"], eps)
    out = (out * (1.0 - lambda_init)).reshape(bsz, seq, embed_dim)
    return out @ params[f"{prefix}/out_proj/kernel"], attn


def differential_attention_specs(prefix: str, embed_dim: int, num_heads: int,
                                 num_kv_heads: Optional[int] = None
                                 ) -> Dict[str, Tuple[tuple, layers.Init]]:
    """Param shapes and initializers (flax Dense's lecun-normal kernels,
    normal(0.1) lambdas, a unit RMSNorm weight)."""
    n_rep = num_heads // (num_kv_heads or num_heads)
    head_dim = embed_dim // (2 * num_heads)
    specs = {f"{prefix}/{name}": ((head_dim,), layers.normal(0.1))
             for name in ("lambda_k1", "lambda_k2", "lambda_q1",
                          "lambda_q2")}
    for name, out in (("k_proj", embed_dim // n_rep),
                      ("out_proj", embed_dim), ("q_proj", embed_dim),
                      ("v_proj", embed_dim // n_rep)):
        specs[f"{prefix}/{name}/kernel"] = ((embed_dim, out),
                                            layers.lecun_normal)
    specs[f"{prefix}/subln/weight"] = ((2 * head_dim,), layers.ones)
    return specs


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
