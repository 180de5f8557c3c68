"""The generated policy ViT, DINOv2 path (counterpart of
hypervla_tpu/models/base_vit.py).

Flow: ImageNet-normalise the frame -> shared DINOv2 trunk -> drop the CLS
token -> project to hidden_dim -> append zero action tokens -> learned
positions -> tiny transformer under the segment mask -> the last
`action_token_num` embeddings. In training the trunk runs once over the
whole batch (`train_image_embeddings`) and the per-sample policy consumes
its patch embeddings, detached unless fine_tune_pretrained_image_encoder.
Params live under the JAX package's names (encoder/image_encoder,
encoder/image_embedding_projection, encoder/pos_embedding,
encoder/Transformer_0).

Other encoder types, language tokens, the class token, positions on the
action tokens only, and differential attention are not ported yet and
raise (ROADMAP.md, queue A3), as do the trunk switches with no counterpart
(`check_trunk_switches`).
"""
from typing import Dict, Tuple

import torch

from hypervla_tpu_torch.configs import dinov2_config, refuse_dropout
from hypervla_tpu_torch.models import layers
from hypervla_tpu_torch.models.encoders.dinov2 import (
    dinov2_forward,
    dinov2_serving_forward,
    dinov2_specs,
    layer_norm_fn,
)
from hypervla_tpu_torch.models.transformer import transformer, transformer_specs
from hypervla_tpu_torch.utils.convert import subtree

DINO_IMAGE_MEAN = (0.485, 0.456, 0.406)
DINO_IMAGE_STD = (0.229, 0.224, 0.225)
RESOLUTION = 224


def segment_attention_mask(batch, n_patch, n_action, device=None):
    """Boolean (B, 1, L, L) mask over [patches | action] segments: full
    attention, except that no patch row may look at the trailing action
    tokens (hypervla_tpu/models/base_vit.py::_segment_attention_mask
    without language tokens)."""
    total = n_patch + n_action
    mask = torch.ones((batch, 1, total, total), dtype=torch.bool,
                      device=device)
    mask[:, :, :n_patch, n_patch:] = False
    return mask


def normalize_pixels(images):
    """uint8 (B, H, W, 3) -> ImageNet-normalised fp32 pixels."""
    mean = torch.tensor(DINO_IMAGE_MEAN, device=images.device)
    std = torch.tensor(DINO_IMAGE_STD, device=images.device)
    return (images.float() / 255.0 - mean) / std


def _check_resolution(images):
    if tuple(images.shape[1:3]) != (RESOLUTION, RESOLUTION):
        raise ValueError(f"DINOv2 input must be {RESOLUTION}x{RESOLUTION}")


def check_trunk_switches(vit_kwargs: dict) -> None:
    """Raises NotImplementedError for a trunk switch of the JAX package
    (hypervla_tpu/models/base_vit.py) that the port has no counterpart for,
    rather than run the plain trunk without a word, and ValueError for a
    combination the JAX package refuses."""
    kw = vit_kwargs
    if kw.get("flash_attention_trainable", False):
        raise NotImplementedError(
            "vit_kwargs flash_attention_trainable=True is not ported: the "
            "differentiable flash attention is a library kernel in the JAX "
            "package, and its hand-written twin is still to write "
            "(ROADMAP.md, queue A4)")
    layer_norm_fn(kw.get("fused_layer_norm", False))
    impl = kw.get("dino_layers_impl")
    if impl not in (None, "pallas_train", "pallas_serving"):
        raise NotImplementedError(
            f"vit_kwargs dino_layers_impl={impl!r} is not ported (the XLA "
            "scan twins of the serving trunk have no counterpart; "
            "ROADMAP.md A3)")
    remat = kw.get("remat_dino", False) or kw.get("dino_remat_policy")
    if (kw.get("dino_fused_add_ln", False) and remat
            and impl != "pallas_train"
            and not kw.get("sow_dino_attention", True)):
        raise ValueError("dino_fused_add_ln is incompatible with layer remat "
                         "(remat_dino, dino_remat_policy)")
    for key in ("remat_dino", "dino_remat_policy"):
        if kw.get(key):
            raise NotImplementedError(
                f"vit_kwargs {key}={kw[key]!r} is not ported: the trunk "
                "keeps every layer's activations for the backward, and a "
                "config that asks for rematerialisation would report "
                "another peak memory than it set out to (ROADMAP.md, queue "
                "A8)")
    if kw.get("scan_dino_layers", False):
        raise NotImplementedError(
            "vit_kwargs scan_dino_layers=True is not ported: it stacks the "
            "trunk's params under encoder/layers/layer, a layout the port "
            "does not read (unstack the tree with the JAX package's "
            "unstack_layer_params and leave the switch off; ROADMAP.md, "
            "queue A8)")
    # dino_dot_softmax is accepted and changes nothing: it only re-lays the
    # softmax sums out for the TPU's matrix unit, the same values up to rounding


class ViT:
    """Config holder + forward of the DINOv2 policy ViT."""

    def __init__(self, vit_kwargs: dict, action_token_num: int):
        kw = vit_kwargs
        unsupported = {
            "encoder_type": kw.get("encoder_type") != "DINOv2",
            "use_language_token": kw.get("use_language_token", False),
            "use_differential_transformer": kw.get(
                "use_differential_transformer", False),
            "include_class_token": kw.get("include_class_token", False),
            "return_attention_map": kw.get("return_attention_map", False),
            "add_positional_embedding": not kw.get(
                "add_positional_embedding", True),
        }
        for name, bad in unsupported.items():
            if bad:
                raise NotImplementedError(
                    f"vit_kwargs {name}={kw.get(name)!r} is not ported yet "
                    "(ROADMAP.md, queue A3)"
                )
        check_trunk_switches(kw)
        refuse_dropout("vit_kwargs", kw)
        self.dino = dinov2_config(kw.get("pretrained_encoder_name",
                                         "dinov2-base"))
        self.encoder_dtype = str(kw.get("encoder_dtype", "float32"))
        self.fine_tune = kw.get("fine_tune_pretrained_image_encoder", False)
        # the JAX trunk takes the fused attention, the forward-only flash
        # attention (ops/flash_attention.py) and the fused residual
        # boundaries (ops/add_layer_norm.py) only when it does not capture
        # attention maps (sow_dino_attention defaults to on)
        capture = kw.get("sow_dino_attention", True)
        self.fused_attention = (kw.get("dino_fused_attention", False)
                                and not capture)
        self.use_flash = kw.get("use_flash_attention", False) and not capture
        self.fused_add_ln = kw.get("dino_fused_add_ln", False) and not capture
        # the trunk's layers as the differentiable layer kernel
        # (ops/dino_layer_train.py; it wins over fused_add_ln), and the
        # LayerNorm choice
        self.layer_kernel = kw.get("dino_layers_impl") == "pallas_train"
        self.fused_ln = kw.get("fused_layer_norm", False)
        if self.layer_kernel and not self.bf16_trunk:
            raise ValueError("dino_layers_impl='pallas_train' is a bf16 "
                             "kernel: set encoder_dtype='bfloat16'")
        self.hidden_dim = kw["hidden_dim"]
        self.num_layers = kw["num_layers"]
        self.num_heads = kw["num_heads"]
        self.mlp_dim = kw["mlp_dim"]
        self.action_token_num = action_token_num
        self.n_patch = (RESOLUTION // self.dino.patch_size) ** 2

    @property
    def bf16_trunk(self) -> bool:
        return self.encoder_dtype in ("bfloat16", "bf16")

    def _trunk_switches(self) -> dict:
        return dict(fused_attention=self.fused_attention,
                    layer_kernel=self.layer_kernel, fused_ln=self.fused_ln,
                    use_flash=self.use_flash, fused_add_ln=self.fused_add_ln)

    def image_embeddings(self, params: Dict[str, torch.Tensor], images,
                         trunk_impl: str = "kernel"):
        """uint8 (B, 224, 224, 3) -> DINOv2 patch embeddings (fp32). A bf16
        trunk runs over params prepared by ops/serving.py: the stacked trunk
        (trunk_impl "kernel", or "reference" for its plain version), or,
        with "layers", the layer loop over the bf16-stored per-layer leaves
        under the trunk switches of the config, as the JAX serving step does
        without its trunk kernel ("layers_reference": the same with the
        plain versions of the forward-only serving kernels). An fp32 trunk
        always runs the layer loop."""
        pixels = normalize_pixels(images)
        enc = subtree(params, "encoder/image_encoder/")
        if self.bf16_trunk and trunk_impl in ("kernel", "reference"):
            emb = dinov2_serving_forward(self.dino, enc, pixels, trunk_impl)
        else:
            dtype = torch.bfloat16 if self.bf16_trunk else torch.float32
            emb = dinov2_forward(self.dino, enc, pixels, dtype,
                                 plain=trunk_impl == "layers_reference",
                                 **self._trunk_switches())
        return emb[:, 1:]  # drop the CLS token

    def train_image_embeddings(self, trunk_params: Dict[str, torch.Tensor],
                               images):
        """uint8 (B, 224, 224, 3) -> patch embeddings (fp32) from the
        differentiable training trunk over per-layer params (keys under
        encoder/image_encoder/, prefix removed), in the encoder dtype, under
        the trunk switches of the config (the fused training attention, the
        layer kernel, the LayerNorm choice, the fused residual
        boundaries)."""
        _check_resolution(images)
        dtype = torch.bfloat16 if self.bf16_trunk else torch.float32
        emb = dinov2_forward(self.dino, trunk_params, normalize_pixels(images),
                             dtype, **self._trunk_switches())
        return emb[:, 1:]

    def __call__(self, params: Dict[str, torch.Tensor], images=None,
                 trunk_impl: str = "kernel", image_embeddings=None):
        """Readout embeddings (B, action_token_num, hidden_dim) from uint8
        images, or from patch embeddings computed outside (the training
        step's batched trunk). params may carry a leading per-sample axis
        (models/hypernetwork.py::per_sample_view)."""
        emb = image_embeddings
        if emb is None:
            _check_resolution(images)
            emb = self.image_embeddings(params, images, trunk_impl)
        if not self.fine_tune:
            emb = emb.detach()
        batch = emb.shape[0]
        patches = layers.dense(emb,
                               params["encoder/image_embedding_projection/kernel"],
                               params["encoder/image_embedding_projection/bias"])
        x = torch.cat([patches, patches.new_zeros(
            batch, self.action_token_num, self.hidden_dim)], dim=1)
        x = x + params["encoder/pos_embedding"]
        mask = segment_attention_mask(batch, patches.shape[1],
                                      self.action_token_num, emb.device)
        x = transformer(params, "encoder/Transformer_0", x, mask,
                        self.num_layers, self.num_heads)
        return x[:, -self.action_token_num:]

    def specs(self) -> Dict[str, Tuple[tuple, layers.Init]]:
        """Param shapes and initializers under encoder/."""
        n_pos = self.n_patch + self.action_token_num
        specs = {
            "encoder/image_embedding_projection/bias": (
                (self.hidden_dim,), layers.zeros),
            "encoder/image_embedding_projection/kernel": (
                (self.dino.hidden_size, self.hidden_dim), layers.lecun_normal),
            "encoder/pos_embedding": (
                (1, n_pos, self.hidden_dim), layers.normal(0.02)),
        }
        specs.update(dinov2_specs(self.dino, "encoder/image_encoder"))
        specs.update(transformer_specs(
            "encoder/Transformer_0", self.hidden_dim, self.num_layers,
            self.mlp_dim, self.num_heads))
        return specs
