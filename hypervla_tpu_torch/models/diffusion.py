"""The MLP-ResNet score network of the diffusion action head (counterpart
of hypervla_tpu/models/diffusion.py) and the cosine noise schedule
(hypervla_tpu/models/unet.py::unet_squaredcos_cap_v2).

eps = ScoreActor(obs_embedding, noisy_actions, t): the time encoder
(learnable Fourier features, Dense(2 * time_dim), swish, Dense(time_dim))
on t, concatenated with the observation embedding and the noisy actions,
through the residual trunk: Dense(hidden_dim), `num_blocks` pre-norm
residual blocks ([dropout ->] [LayerNorm ->] Dense(4 * hidden_dim) ->
swish -> Dense(hidden_dim), added to the input), swish, Dense(out_dim).

Params live under the JAX package's keys. The blocks' params are stacked
on a leading depth axis under one key each, as the JAX trunk's nn.scan
stores them (`<prefix>/trunk/blocks/Dense_0/kernel` is (num_blocks,
hidden_dim, 4 * hidden_dim)), so the hypernetwork generates them under the
JAX keys and utils/convert.py carries them as they are. A param may carry
a leading per-sample axis (models/hypernetwork.py::per_sample_view): the
training step's per-sample generated score network.
"""
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from hypervla_tpu_torch.models import layers
from hypervla_tpu_torch.models.draws import Draws, dropout


def unet_squaredcos_cap_v2(timesteps: int, s: float = 0.008) -> torch.Tensor:
    """The cosine noise schedule's betas (Nichol & Dhariwal), clipped to
    0.999, computed in fp32 on the host as the JAX package computes them."""
    grid = torch.arange(timesteps + 1, dtype=torch.float32) / timesteps
    alpha_bar = torch.cos((grid + s) / (1 + s) * (math.pi / 2)) ** 2
    alpha_bar = alpha_bar / alpha_bar[0]
    return torch.clamp(1 - alpha_bar[1:] / alpha_bar[:-1], 0, 0.999)


def _running_product(x: torch.Tensor) -> torch.Tensor:
    out = x.clone()
    for i in range(1, x.shape[0]):
        out[i] = out[i - 1] * x[i]
    return out


def blocked_cumprod(x: torch.Tensor, block: int = 16) -> torch.Tensor:
    """The cumulative product of a 1-D fp32 tensor in the order the JAX
    package's jnp.cumprod takes on XLA: XLA rewrites the reduce-window of
    a cumulative product into blocks of 16, a running product inside each
    block times the product of the blocks before it (itself taken the same
    way), so the schedule's alpha_bars round as the JAX ones do. The
    running products are fp32 products one after the other (torch.cumprod
    accumulates in fp64 on the CPU)."""
    n = x.shape[0]
    if n <= block:
        return _running_product(x)
    blocks = -(-n // block)
    padded = torch.ones(blocks * block, dtype=x.dtype)
    padded[:n] = x
    within = torch.stack([_running_product(row)
                          for row in padded.reshape(blocks, block)])
    before = torch.ones(blocks, dtype=x.dtype)
    before[1:] = blocked_cumprod(within[:-1, -1], block)
    return (within * before[:, None]).reshape(-1)[:n]


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> torch.Tensor:
    """The diffusion head's schedule: the U-Net head's curve."""
    return unet_squaredcos_cap_v2(timesteps, s=s)


def stacked(init: layers.Init) -> layers.Init:
    """An initializer of a (depth, ...) param: each slice drawn on its own,
    as nn.scan's split params rngs init each block (a fan-in over the
    slice, not over the depth axis)."""
    def draw(shape, gen):
        return torch.stack([init(shape[1:], gen) for _ in range(shape[0])])
    return draw


def _dense_specs(prefix, fan_in, fan_out, init):
    return {f"{prefix}/bias": ((fan_out,), layers.zeros),
            f"{prefix}/kernel": ((fan_in, fan_out), init)}


class ScoreActor:
    """The score network under `prefix` (the diffusion head's
    "action_head/diffusion_model")."""

    def __init__(self, prefix: str, out_dim: int, time_dim: int = 32,
                 num_blocks: int = 3, hidden_dim: int = 256,
                 dropout_rate: float = 0.0, use_layer_norm: bool = True):
        self.prefix = prefix
        self.out_dim = out_dim
        self.time_dim = time_dim
        self.num_blocks = num_blocks
        self.hidden_dim = hidden_dim
        self.dropout_rate = dropout_rate or 0.0
        self.use_layer_norm = use_layer_norm

    def _dense(self, params, name, x):
        return layers.dense(x, params[f"{self.prefix}/{name}/kernel"],
                            params[f"{self.prefix}/{name}/bias"])

    def _block(self, params, name, i, per_sample):
        """Block i's slice of a stacked param: (B, in, out) or (B, 1, d)
        per sample, (in, out) or (d,) shared."""
        value = params[f"{self.prefix}/trunk/blocks/{name}"]
        depth = self.num_blocks
        if not per_sample:
            return value[i]
        if name.endswith("kernel"):
            return value[:, i]
        # a vector per sample arrives (B, 1, depth, d), or (B, d) at depth 1
        return value.reshape(value.shape[0], depth, -1)[:, i, None]

    def time_embedding(self, params, time):
        """time (B, n, 1) -> (B, n, time_dim)."""
        freqs = params[f"{self.prefix}/time_encoder/kernel"]
        angles = (2 * math.pi) * (time.float() @ freqs.transpose(-1, -2))
        emb = torch.cat([torch.cos(angles), torch.sin(angles)], dim=-1)
        emb = F.silu(self._dense(params, "time_encoder/Dense_0", emb))
        return self._dense(params, "time_encoder/Dense_1", emb)

    def __call__(self, params: Dict[str, torch.Tensor], obs_enc, actions,
                 time, draws: Optional[Draws] = None):
        """obs_enc (B, ..., emb), actions (B, ..., out_dim) and time
        (B, ..., 1), all with the same leading shape -> eps (B, ...,
        out_dim). draws: the blocks' dropout, one site a block."""
        lead = actions.shape[:-1]
        batch = lead[0]

        def rows(x):
            return x.reshape(batch, -1, x.shape[-1])

        t_emb = self.time_embedding(params, rows(time))
        x = torch.cat([t_emb, rows(obs_enc).float(), rows(actions)], dim=-1)
        per_sample = params[f"{self.prefix}/trunk/Dense_0/kernel"].dim() == 3
        h = self._dense(params, "trunk/Dense_0", x)
        for i in range(self.num_blocks):
            def block(name):
                return self._block(params, name, i, per_sample)

            r = dropout(h, self.dropout_rate, draws,
                        f"{self.prefix}/trunk/blocks/{i}/Dropout_0")
            if self.use_layer_norm:
                r = layers.layer_norm(r, block("LayerNorm_0/scale"),
                                      block("LayerNorm_0/bias"))
            r = layers.dense(r, block("Dense_0/kernel"),
                             block("Dense_0/bias"))
            r = layers.dense(F.silu(r), block("Dense_1/kernel"),
                             block("Dense_1/bias"))
            h = h + r
        out = self._dense(params, "trunk/Dense_1", F.silu(h))
        return out.reshape(*lead, self.out_dim)

    def specs(self, obs_dim: int) -> Dict[str, Tuple[tuple, layers.Init]]:
        """Param shapes and initializers for an observation embedding of
        width obs_dim: xavier_uniform on the time encoder's and the trunk's
        outer Dense layers, flax's default (lecun_normal) on the blocks',
        normal(0.2) on the Fourier frequencies."""
        p, h, depth = self.prefix, self.hidden_dim, self.num_blocks
        xavier = layers.xavier_uniform()
        specs = {f"{p}/time_encoder/kernel": ((self.time_dim // 2, 1),
                                              layers.normal(0.2))}
        specs.update(_dense_specs(f"{p}/time_encoder/Dense_0", self.time_dim,
                                  2 * self.time_dim, xavier))
        specs.update(_dense_specs(f"{p}/time_encoder/Dense_1",
                                  2 * self.time_dim, self.time_dim, xavier))
        specs.update(_dense_specs(f"{p}/trunk/Dense_0",
                                  self.time_dim + obs_dim + self.out_dim, h,
                                  xavier))
        blocks = f"{p}/trunk/blocks"
        specs.update({
            f"{blocks}/Dense_0/bias": ((depth, 4 * h), layers.zeros),
            f"{blocks}/Dense_0/kernel": ((depth, h, 4 * h),
                                         stacked(layers.lecun_normal)),
            f"{blocks}/Dense_1/bias": ((depth, h), layers.zeros),
            f"{blocks}/Dense_1/kernel": ((depth, 4 * h, h),
                                         stacked(layers.lecun_normal)),
        })
        if self.use_layer_norm:
            specs.update({f"{blocks}/LayerNorm_0/bias": ((depth, h),
                                                         layers.zeros),
                          f"{blocks}/LayerNorm_0/scale": ((depth, h),
                                                          layers.ones)})
        specs.update(_dense_specs(f"{p}/trunk/Dense_1", h, self.out_dim,
                                  xavier))
        return specs
