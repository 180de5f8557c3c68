"""Pre-LN transformer encoder (counterpart of
hypervla_tpu/models/transformer.py: MlpBlock, Encoder1DBlock, Transformer).

Param names are the JAX package's auto-names (encoderblock_<i>,
LayerNorm_0/1, MlpBlock_0/Dense_0/1, MultiHeadAttention_0, encoder_norm,
posembed_input). Dropout runs where the JAX modules drop, at their module
paths under `prefix` (models/draws.py): after the position table
(Dropout_0 of the stack), on the attention weights
(MultiHeadAttention_0), after the attention (Dropout_0 of a block), after
the MLP's GELU and after its output (MlpBlock_0/Dropout_0, Dropout_1);
without draws it is the identity. learnable_norm=False strips the
LayerNorms' scale and bias, as the JAX stack's switch does.
use_differential_transformer swaps each block's attention for the
differential attention (models/attention.py, "DifferentialAttention_0",
lambda_init from the block's depth), which takes no attention dropout.

`map_head` is the JAX MAPHead: learned probe tokens cross-attend into a
sequence, then a residual MLP (the pooling of the Octo heads and of the
TokenLearner).
"""
from typing import Dict, List, Optional, Tuple

from hypervla_tpu_torch.models import layers
from hypervla_tpu_torch.models.attention import (
    differential_attention,
    differential_attention_specs,
    multi_head_attention,
    multi_head_attention_specs,
)
from hypervla_tpu_torch.models.draws import Draws, dropout


def mlp_block(params, prefix: str, x, dropout_rate: float = 0.0,
              draws: Optional[Draws] = None):
    """Dense -> GELU (tanh approximation, flax's nn.gelu) -> dropout ->
    Dense -> dropout."""
    h = layers.dense(x, params[f"{prefix}/Dense_0/kernel"],
                     params[f"{prefix}/Dense_0/bias"])
    h = dropout(layers.gelu_tanh(h), dropout_rate, draws,
                f"{prefix}/Dropout_0")
    h = layers.dense(h, params[f"{prefix}/Dense_1/kernel"],
                     params[f"{prefix}/Dense_1/bias"])
    return dropout(h, dropout_rate, draws, f"{prefix}/Dropout_1")


def _ln(params, prefix, x, learnable: bool = True):
    if not learnable:
        return layers.layer_norm(x)
    return layers.layer_norm(x, params[f"{prefix}/scale"],
                             params[f"{prefix}/bias"])


def encoder_block(params, prefix: str, x, mask, num_heads: int,
                  dropout_rate: float = 0.0,
                  attention_dropout_rate: float = 0.0,
                  draws: Optional[Draws] = None,
                  maps: Optional[List] = None, learnable_norm: bool = True,
                  differential: bool = False, depth: int = 0):
    """One block; its attention probabilities (after the attention
    dropout, as the JAX block returns them; with `differential`, the
    differential map) are appended to `maps`."""
    y = _ln(params, f"{prefix}/LayerNorm_0", x, learnable_norm)
    if differential:
        attended, probs = differential_attention(
            params, f"{prefix}/DifferentialAttention_0", y, mask,
            y.shape[-1], num_heads, depth=depth)
    else:
        attended, probs = multi_head_attention(
            params, f"{prefix}/MultiHeadAttention_0", y, y, mask, num_heads,
            attention_dropout_rate, draws, return_weights=True)
    if maps is not None:
        maps.append(probs)
    x = x + dropout(attended, dropout_rate, draws, f"{prefix}/Dropout_0")
    y = _ln(params, f"{prefix}/LayerNorm_1", x, learnable_norm)
    return x + mlp_block(params, f"{prefix}/MlpBlock_0", y, dropout_rate,
                         draws)


def transformer(params, prefix: str, x, mask, num_layers: int,
                num_attention_heads: int, dropout_rate: float = 0.0,
                attention_dropout_rate: float = 0.0,
                add_position_embedding: bool = False,
                draws: Optional[Draws] = None,
                maps: Optional[List] = None, learnable_norm: bool = True,
                use_differential_transformer: bool = False):
    """(batch, len, emb) -> encoded (batch, len, emb). maps, if given,
    collects every block's attention probabilities (batch, heads, len,
    len)."""
    if add_position_embedding:
        x = x + params[f"{prefix}/posembed_input/pos_embedding"]
        x = dropout(x, dropout_rate, draws, f"{prefix}/Dropout_0")
    for depth in range(num_layers):
        x = encoder_block(params, f"{prefix}/encoderblock_{depth}", x, mask,
                          num_attention_heads, dropout_rate,
                          attention_dropout_rate, draws, maps,
                          learnable_norm, use_differential_transformer,
                          depth)
    return _ln(params, f"{prefix}/encoder_norm", x, learnable_norm)


def transformer_specs(prefix: str, embedding_dim: int, num_layers: int,
                      mlp_dim: int, num_attention_heads: int,
                      position_embedding_len: int = 0,
                      learnable_norm: bool = True,
                      use_differential_transformer: bool = False
                      ) -> Dict[str, Tuple[tuple, layers.Init]]:
    """Param shapes and initializers of `transformer`; with
    position_embedding_len, the (1, len, emb) table of
    add_position_embedding."""
    specs = {}

    def norm(name):
        if not learnable_norm:
            return
        specs[f"{name}/bias"] = ((embedding_dim,), layers.zeros)
        specs[f"{name}/scale"] = ((embedding_dim,), layers.ones)

    if position_embedding_len:
        specs[f"{prefix}/posembed_input/pos_embedding"] = (
            (1, position_embedding_len, embedding_dim), layers.normal(0.02))
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
        if use_differential_transformer:
            specs.update(differential_attention_specs(
                f"{block}/DifferentialAttention_0", embedding_dim,
                num_attention_heads))
        else:
            specs.update(multi_head_attention_specs(
                f"{block}/MultiHeadAttention_0", embedding_dim,
                num_attention_heads))
    norm(f"{prefix}/encoder_norm")
    return specs


def _mlp_specs(prefix, dim, mlp_dim, out_dim):
    specs = {}
    for name, fin, fout in (("Dense_0", dim, mlp_dim),
                            ("Dense_1", mlp_dim, out_dim)):
        specs[f"{prefix}/{name}/bias"] = ((fout,), layers.normal(1e-6))
        specs[f"{prefix}/{name}/kernel"] = ((fin, fout),
                                            layers.xavier_uniform())
    return specs


def map_head(params, prefix: str, x, mask=None, num_readouts: int = 1,
             num_heads: int = 8, dropout_rate: float = 0.1,
             draws: Optional[Draws] = None):
    """MAPHead (hypervla_tpu/models/transformer.py): x (..., seq, dim) and
    its key mask (..., seq) or None -> (..., num_readouts, dim). The probe
    tokens (1, num_readouts, dim) attend into x; the MLP's dropout
    (flax's default rate, 0.1) runs where draws are given, the JAX
    module's train=True."""
    *lead, seq, dim = x.shape
    x = x.reshape(-1, seq, dim)
    flat_batch = x.shape[0]
    probe = params[f"{prefix}/probe"].expand(flat_batch, num_readouts, dim)
    if mask is not None:
        mask = mask.reshape(-1, seq)[:, None, None, :].expand(
            flat_batch, 1, num_readouts, seq).bool()
    pooled = multi_head_attention(params, f"{prefix}/MultiHeadAttention_0",
                                  probe, x, mask, num_heads)
    pooled = pooled + mlp_block(
        params, f"{prefix}/MlpBlock_0",
        _ln(params, f"{prefix}/LayerNorm_0", pooled), dropout_rate, draws)
    return pooled.reshape(*lead, num_readouts, dim)


def map_head_specs(prefix: str, dim: int, num_readouts: int = 1,
                   num_heads: int = 8, mlp_dim: Optional[int] = None
                   ) -> Dict[str, Tuple[tuple, layers.Init]]:
    specs = {f"{prefix}/probe": ((1, num_readouts, dim),
                                 layers.xavier_uniform())}
    specs.update(multi_head_attention_specs(
        f"{prefix}/MultiHeadAttention_0", dim, num_heads))
    specs[f"{prefix}/LayerNorm_0/bias"] = ((dim,), layers.zeros)
    specs[f"{prefix}/LayerNorm_0/scale"] = ((dim,), layers.ones)
    specs.update(_mlp_specs(f"{prefix}/MlpBlock_0", dim, mlp_dim or 4 * dim,
                            dim))
    return specs
