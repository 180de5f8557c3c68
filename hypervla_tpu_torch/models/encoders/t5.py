"""The frozen T5 text encoder (counterpart of
hypervla_tpu/models/encoders/t5.py): RMS layer norm (no bias, no mean
subtraction), no 1/sqrt(d_kv) attention scaling, a relative position bias
computed in block 0 and shared by every block, ReLU feed-forward.

Params keep the JAX package's tree, flattened: shared_embedding,
block_<i>/layer_0_layer_norm/weight, block_<i>/layer_0_SelfAttention/
{q,k,v,o}/kernel, block_0/layer_0_SelfAttention/relative_attention_bias,
block_<i>/layer_1_layer_norm/weight, block_<i>/layer_1_DenseReluDense_
{wi,wo}/kernel, final_layer_norm/weight. Dense kernels are (in, out).
Dropout is the identity (the encoder runs deterministic).
"""
import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from hypervla_tpu_torch.models import layers


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 768
    d_kv: int = 64
    d_ff: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    initializer_factor: float = 1.0


_NAMED_CONFIGS = {
    "t5-small": T5Config(d_model=512, d_ff=2048, num_layers=6, num_heads=8),
    "t5-base": T5Config(),
    "t5-large": T5Config(d_model=1024, d_ff=4096, num_layers=24,
                         num_heads=16),
}


def t5_config(name: str) -> T5Config:
    key = name.split("/")[-1]
    if key not in _NAMED_CONFIGS:
        raise ValueError(f"unknown T5 config {name}")
    return _NAMED_CONFIGS[key]


def relative_position_bucket(relative_position, num_buckets: int = 32,
                             max_distance: int = 128):
    """Bidirectional T5 relative-position buckets of an int numpy array."""
    ret = 0
    n = -relative_position
    num_buckets //= 2
    ret += (n < 0).astype(np.int32) * num_buckets
    n = np.abs(n)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        np.log(n.astype(np.float32) / max_exact + 1e-6)
        / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int32)
    val_if_large = np.minimum(val_if_large, num_buckets - 1)
    ret += np.where(is_small, n, val_if_large)
    return ret


def _rms_norm(x, weight, eps):
    variance = x.float().pow(2).mean(-1, keepdim=True)
    return weight * (x * torch.rsqrt(variance + eps))


def t5_encode(config: T5Config, params: Dict[str, torch.Tensor], input_ids,
              attention_mask=None):
    """input_ids (B, L) int -> last_hidden_state (B, L, d_model) fp32;
    attention_mask (B, L), nonzero = attend."""
    c = config
    seq = input_ids.shape[1]
    x = params["shared_embedding"][input_ids.long()].float()
    ctx = np.arange(seq)[:, None]
    buckets = relative_position_bucket(
        np.arange(seq)[None, :] - ctx, c.relative_attention_num_buckets,
        c.relative_attention_max_distance)
    rel = params["block_0/layer_0_SelfAttention/relative_attention_bias"]
    position_bias = rel[torch.as_tensor(buckets, device=rel.device).long()]
    position_bias = position_bias.permute(2, 0, 1)[None]  # (1, h, q, k)
    keep = (None if attention_mask is None
            else attention_mask.bool()[:, None, None, :])

    def heads(t):
        return t.reshape(*t.shape[:2], c.num_heads, c.d_kv)

    for i in range(c.num_layers):
        blk = f"block_{i}"
        att = f"{blk}/layer_0_SelfAttention"
        n = _rms_norm(x, params[f"{blk}/layer_0_layer_norm/weight"],
                      c.layer_norm_epsilon)
        q, k, v = (heads(n @ params[f"{att}/{w}/kernel"]) for w in "qkv")
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) + position_bias
        if keep is not None:
            scores = torch.where(keep, scores, torch.finfo(scores.dtype).min)
        weights = torch.softmax(scores.float(), dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        x = x + out.reshape(*out.shape[:2], -1) @ params[f"{att}/o/kernel"]
        n = _rms_norm(x, params[f"{blk}/layer_1_layer_norm/weight"],
                      c.layer_norm_epsilon)
        y = torch.relu(n @ params[f"{blk}/layer_1_DenseReluDense_wi/kernel"])
        x = x + y @ params[f"{blk}/layer_1_DenseReluDense_wo/kernel"]
    return _rms_norm(x, params["final_layer_norm/weight"],
                     c.layer_norm_epsilon).float()


def t5_specs(config: T5Config) -> Dict[str, Tuple[tuple, layers.Init]]:
    """Param shapes and initializers (the JAX module's: normal with T5's
    per-projection std, unit norm weights)."""
    c = config
    f = c.initializer_factor
    inner = c.num_heads * c.d_kv
    specs = {"shared_embedding": ((c.vocab_size, c.d_model),
                                  layers.normal(f * 1.0))}
    for i in range(c.num_layers):
        blk = f"block_{i}"
        att = f"{blk}/layer_0_SelfAttention"
        specs.update({
            f"{blk}/layer_0_layer_norm/weight": ((c.d_model,), layers.ones),
            f"{att}/q/kernel": (
                (c.d_model, inner),
                layers.normal(f * (c.d_model * c.d_kv) ** -0.5)),
            f"{att}/k/kernel": ((c.d_model, inner),
                                layers.normal(f * c.d_model ** -0.5)),
            f"{att}/v/kernel": ((c.d_model, inner),
                                layers.normal(f * c.d_model ** -0.5)),
            f"{att}/o/kernel": ((inner, c.d_model),
                                layers.normal(f * inner ** -0.5)),
            f"{blk}/layer_1_layer_norm/weight": ((c.d_model,), layers.ones),
            f"{blk}/layer_1_DenseReluDense_wi/kernel": (
                (c.d_model, c.d_ff), layers.normal(f * c.d_model ** -0.5)),
            f"{blk}/layer_1_DenseReluDense_wo/kernel": (
                (c.d_ff, c.d_model), layers.normal(f * c.d_ff ** -0.5)),
        })
        if i == 0:
            specs[f"{att}/relative_attention_bias"] = (
                (c.relative_attention_num_buckets, c.num_heads),
                layers.normal(f * c.d_model ** -0.5))
    specs["final_layer_norm/weight"] = ((c.d_model,), layers.ones)
    return specs
