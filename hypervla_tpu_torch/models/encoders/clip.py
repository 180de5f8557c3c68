"""The CLIP vision encoder (counterpart of
hypervla_tpu/models/encoders/clip.py).

Params keep the JAX package's HF tree, flattened under vision_model/:
embeddings/{class_embedding, patch_embedding/kernel (kh, kw, cin, cout),
position_embedding/embedding}, pre_layrnorm (HF's spelling),
encoder/layers/<i>/{layer_norm1, self_attn/{q,k,v,out}_proj, layer_norm2,
mlp/{fc1, fc2}}, post_layernorm. Pre-LN blocks with quick_gelu MLPs and
attention scaled by 1/sqrt(head_dim). As in the HF model (and the JAX
one), `last_hidden_state` is the encoder's raw output: post_layernorm stays
in the tree and only feeds the pooled class embedding, which nothing reads.
"""
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

from hypervla_tpu_torch.models import layers


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    patch_size: int = 16
    image_size: int = 224
    num_channels: int = 3
    layer_norm_eps: float = 1e-5


_NAMED_CONFIGS = {
    "clip-vit-base-patch16": CLIPVisionConfig(patch_size=16),
    "clip-vit-base-patch32": CLIPVisionConfig(patch_size=32),
    "clip-vit-large-patch14": CLIPVisionConfig(
        hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
        intermediate_size=4096, patch_size=14),
    "clip-test": CLIPVisionConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, patch_size=16),
}


def clip_vision_config(name: str) -> CLIPVisionConfig:
    key = name.split("/")[-1]
    if key not in _NAMED_CONFIGS:
        raise ValueError(f"unknown CLIP config {name}")
    return _NAMED_CONFIGS[key]


@dataclasses.dataclass
class CLIPVisionOutput:
    last_hidden_state: torch.Tensor
    attentions: Optional[Tuple[torch.Tensor, ...]] = None


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _ln(params, prefix, x, eps):
    return layers.layer_norm(x, params[f"{prefix}/scale"],
                             params[f"{prefix}/bias"], eps)


def _dense(params, prefix, x):
    return layers.dense(x, params[f"{prefix}/kernel"], params[f"{prefix}/bias"])


class CLIPVisionModel:
    """The CLIP vision trunk over a flat param dict (keys under
    "vision_model/"): NHWC pixel values, already normalized, ->
    CLIPVisionOutput."""

    def __init__(self, config: CLIPVisionConfig,
                 dtype: torch.dtype = torch.float32):
        self.config = config
        self.dtype = dtype

    def __call__(self, params: Dict[str, torch.Tensor], pixel_values,
                 output_attentions: bool = False) -> CLIPVisionOutput:
        c = self.config
        top = "vision_model"
        x = pixel_values.to(self.dtype)
        batch, height, width, channels = x.shape
        p = c.patch_size
        # the VALID patch convolution as one GEMM over (kh, kw, cin) patches
        patches = x.reshape(batch, height // p, p, width // p, p, channels)
        patches = patches.permute(0, 1, 3, 2, 4, 5).reshape(
            batch, -1, p * p * channels)
        kernel = params[f"{top}/embeddings/patch_embedding/kernel"]
        tokens = patches @ kernel.reshape(-1, kernel.shape[-1]).to(self.dtype)
        cls = params[f"{top}/embeddings/class_embedding"].to(
            tokens.dtype).expand(batch, 1, c.hidden_size)
        h = torch.cat([cls, tokens], dim=1)
        table = params[f"{top}/embeddings/position_embedding/embedding"]
        h = h + table[:h.shape[1]]
        h = _ln(params, f"{top}/pre_layrnorm", h, c.layer_norm_eps)
        attentions: List[torch.Tensor] = []
        heads = c.num_attention_heads
        head_dim = c.hidden_size // heads
        for i in range(c.num_hidden_layers):
            lp = f"{top}/encoder/layers/{i}"
            y = _ln(params, f"{lp}/layer_norm1", h, c.layer_norm_eps)
            shape = y.shape[:2] + (heads, head_dim)
            q = _dense(params, f"{lp}/self_attn/q_proj", y).reshape(shape)
            k = _dense(params, f"{lp}/self_attn/k_proj", y).reshape(shape)
            v = _dense(params, f"{lp}/self_attn/v_proj", y).reshape(shape)
            q = q / math.sqrt(head_dim)
            weights = torch.softmax(
                torch.einsum("...qhd,...khd->...hqk", q, k), dim=-1)
            out = torch.einsum("...hqk,...khd->...qhd", weights, v)
            h = h + _dense(params, f"{lp}/self_attn/out_proj",
                           out.reshape(out.shape[:2] + (-1,)))
            y = _ln(params, f"{lp}/layer_norm2", h, c.layer_norm_eps)
            y = quick_gelu(_dense(params, f"{lp}/mlp/fc1", y))
            h = h + _dense(params, f"{lp}/mlp/fc2", y)
            if output_attentions:
                attentions.append(weights)
        return CLIPVisionOutput(
            last_hidden_state=h.float(),
            attentions=tuple(attentions) if output_attentions else None)

    def specs(self, prefix: str = "", image_size: Optional[int] = None
              ) -> Dict[str, Tuple[tuple, layers.Init]]:
        """Param shapes and initializers under `prefix` ("" or "a/b"),
        for frames of image_size (default the config's): flax's
        lecun-normal kernels and zero biases, a normal(0.02) class
        embedding, a unit-normal position table (nn.Embed's)."""
        c = self.config
        top = f"{prefix}/vision_model" if prefix else "vision_model"
        side = (image_size or c.image_size) // c.patch_size
        d, f = c.hidden_size, c.intermediate_size

        def norm(name):
            return {f"{name}/bias": ((d,), layers.zeros),
                    f"{name}/scale": ((d,), layers.ones)}

        def dense(name, fin, fout):
            return {f"{name}/bias": ((fout,), layers.zeros),
                    f"{name}/kernel": ((fin, fout), layers.lecun_normal)}

        specs = {
            f"{top}/embeddings/class_embedding": ((d,), layers.normal(0.02)),
            f"{top}/embeddings/patch_embedding/kernel": (
                (c.patch_size, c.patch_size, c.num_channels, d),
                layers.lecun_normal),
            f"{top}/embeddings/position_embedding/embedding": (
                (side * side + 1, d), layers.normal(1.0)),
        }
        for i in range(c.num_hidden_layers):
            lp = f"{top}/encoder/layers/{i}"
            specs.update(norm(f"{lp}/layer_norm1"))
            specs.update(norm(f"{lp}/layer_norm2"))
            specs.update(dense(f"{lp}/mlp/fc1", d, f))
            specs.update(dense(f"{lp}/mlp/fc2", f, d))
            for name in ("k_proj", "out_proj", "q_proj", "v_proj"):
                specs.update(dense(f"{lp}/self_attn/{name}", d, d))
        specs.update(norm(f"{top}/post_layernorm"))
        specs.update(norm(f"{top}/pre_layrnorm"))
        return specs
