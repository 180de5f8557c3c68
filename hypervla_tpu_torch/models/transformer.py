"""Pre-LN transformer encoder (counterpart of
hypervla_tpu/models/transformer.py: MlpBlock, Encoder1DBlock, Transformer).

Param names are the JAX package's auto-names (encoderblock_<i>,
LayerNorm_0/1, MlpBlock_0/Dense_0/1, MultiHeadAttention_0, encoder_norm).
Dropout is the identity at serving time and is not modelled.
"""
from typing import Dict, Tuple

from hypervla_tpu_torch.models import layers
from hypervla_tpu_torch.models.attention import (
    multi_head_attention,
    multi_head_attention_specs,
)


def mlp_block(params, prefix: str, x):
    """Dense -> GELU (tanh approximation, flax's nn.gelu) -> Dense."""
    h = layers.dense(x, params[f"{prefix}/Dense_0/kernel"],
                     params[f"{prefix}/Dense_0/bias"])
    return layers.dense(layers.gelu_tanh(h), params[f"{prefix}/Dense_1/kernel"],
                        params[f"{prefix}/Dense_1/bias"])


def _ln(params, prefix, x):
    return layers.layer_norm(x, params[f"{prefix}/scale"],
                             params[f"{prefix}/bias"])


def encoder_block(params, prefix: str, x, mask, num_heads: int):
    y = _ln(params, f"{prefix}/LayerNorm_0", x)
    x = x + multi_head_attention(params, f"{prefix}/MultiHeadAttention_0",
                                 y, y, mask, num_heads)
    y = _ln(params, f"{prefix}/LayerNorm_1", x)
    return x + mlp_block(params, f"{prefix}/MlpBlock_0", y)


def transformer(params, prefix: str, x, mask, num_layers: int,
                num_attention_heads: int):
    """(batch, len, emb) -> encoded (batch, len, emb)."""
    for depth in range(num_layers):
        x = encoder_block(params, f"{prefix}/encoderblock_{depth}", x, mask,
                          num_attention_heads)
    return _ln(params, f"{prefix}/encoder_norm", x)


def transformer_specs(prefix: str, embedding_dim: int, num_layers: int,
                      mlp_dim: int, num_attention_heads: int
                      ) -> Dict[str, Tuple[tuple, layers.Init]]:
    """Param shapes and initializers of `transformer`."""
    specs = {}

    def norm(name):
        specs[f"{name}/bias"] = ((embedding_dim,), layers.zeros)
        specs[f"{name}/scale"] = ((embedding_dim,), layers.ones)

    for depth in range(num_layers):
        block = f"{prefix}/encoderblock_{depth}"
        norm(f"{block}/LayerNorm_0")
        norm(f"{block}/LayerNorm_1")
        for name, fin, fout in (("Dense_0", embedding_dim, mlp_dim),
                                ("Dense_1", mlp_dim, embedding_dim)):
            specs[f"{block}/MlpBlock_0/{name}/kernel"] = (
                (fin, fout), layers.xavier_uniform())
            specs[f"{block}/MlpBlock_0/{name}/bias"] = (
                (fout,), layers.normal(1e-6))
        specs.update(multi_head_attention_specs(
            f"{block}/MultiHeadAttention_0", embedding_dim,
            num_attention_heads))
    norm(f"{prefix}/encoder_norm")
    return specs
