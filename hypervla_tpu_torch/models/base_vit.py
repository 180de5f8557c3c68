"""The generated policy ViT (counterpart of
hypervla_tpu/models/base_vit.py).

Flow: encode the frame to patch tokens -> (optionally) prepend projected
language tokens -> append zero action tokens -> learned positions -> tiny
transformer under the segment mask -> the last `action_token_num`
embeddings. The encoders:

  * "DINOv2": ImageNet-normalise, the shared DINOv2 trunk, drop the CLS
    token unless include_class_token, project to hidden_dim. In training
    the trunk runs once over the whole batch (`train_image_embeddings`) and
    the per-sample policy consumes its patch embeddings, detached unless
    fine_tune_pretrained_image_encoder;
  * "CLIP" (models/encoders/clip.py, clip-vit-base-patch16): normalise
    with CLIP's pixel statistics, the shared CLIP trunk, drop the class
    token, project to hidden_dim; in training it runs once over the batch,
    as the DINOv2 trunk does;
  * "Siglip": the batch's precomputed patch embeddings (observation
    patch_embeddings, which the JAX base net reads too) projected to
    hidden_dim, never detached;
  * "EfficientNet" (models/efficientnet.py, efficientnet-b3 at 300 px):
    the [-1, 1] frame through the backbone, then a 1x1 convolution to
    hidden_dim ("encoder/Conv_0"); stochastic depth in training, and, as in
    the JAX package, a forward without draws raises InvalidRngError (the
    JAX serving path gives the backbone no "drop_connect" stream);
  * "SmallStem" and "PatchEncoder" (models/vit_encoders.py): convolutions
    whose kernels the hypernetwork generates like any other block.

Params live under the JAX package's names (encoder/image_encoder,
encoder/image_embedding_projection, encoder/SmallStem_0,
encoder/PatchEncoder_0, encoder/EfficientNet_0, encoder/Conv_0,
encoder/language_token_projection, encoder/pos_embedding,
encoder/Transformer_0). use_differential_transformer runs the policy
transformer on differential attention (models/transformer.py).

In training (given a models/draws.py::Draws) the JAX ViT's dropout runs on
the tokens after the position table ("encoder/Dropout_0") and in the
transformer's attention outputs and MLPs (dropout_rate; its attention
weights take none), and image_embedding_noise adds noise * N(0, 1) to the
trunk's embeddings ("embedding_noise"), per sample after the batched
trunk. The trunk switches: sow_dino_attention (default on) runs the trunk
on the einsum attention, the fused attention, flash and fused residual
boundaries off, as the JAX trunk does for output_attentions, and
`image_embeddings` can then return its maps; remat_dino and
dino_remat_policy checkpoint the trunk's layers (models/encoders/
dinov2.py::remat_context); scan_dino_layers reads the trunk converted
from the JAX package's stacked layout into per-layer keys
(utils/convert.py) and runs the same layer loop with the routes the JAX
scanned stack takes (no fused attention, no fused residual boundaries, no
remat). return_attention_map surfaces the transformer's attention maps
(`__call__`'s maps).

The trunk switches with no counterpart raise (`check_trunk_switches`).
"""
from typing import Dict, Optional, Tuple

import torch

from hypervla_tpu_torch.configs import dinov2_config
from hypervla_tpu_torch.models import layers
from hypervla_tpu_torch.models.draws import Draws, dropout
from hypervla_tpu_torch.models.efficientnet import (
    MODEL_CONFIGS,
    EfficientNet,
    conv_same,
    output_side,
)
from hypervla_tpu_torch.models.encoders.clip import (
    CLIPVisionModel,
    clip_vision_config,
)
from hypervla_tpu_torch.models.encoders.dinov2 import (
    REMAT_SAVED,
    dinov2_forward,
    dinov2_serving_forward,
    dinov2_specs,
    layer_norm_fn,
)
from hypervla_tpu_torch.models.transformer import transformer, transformer_specs
from hypervla_tpu_torch.models.vit_encoders import (
    PatchEncoder,
    SmallStem,
    normalize_images,
)
from hypervla_tpu_torch.utils.convert import subtree

#: per-encoder pixel statistics (mean, std)
PIXEL_STATS = {
    "DINOv2": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
    "CLIP": ((0.48145466, 0.4578275, 0.40821073),
             (0.26862954, 0.26130258, 0.27577711)),
}
DINO_IMAGE_MEAN, DINO_IMAGE_STD = PIXEL_STATS["DINOv2"]
RESOLUTION = 224
#: the frame size each encoder asserts
EXPECTED_RESOLUTION = {"EfficientNet": 300, "DINOv2": 224, "CLIP": 224,
                       "Siglip": 224}
#: the named configs the JAX ViT builds its CLIP and EfficientNet from
CLIP_NAME = "clip-vit-base-patch16"
EFFICIENTNET_NAME = "efficientnet-b3"
#: the encoders, and the param subtree each lives under
ENCODER_PREFIX = {"DINOv2": "encoder/image_encoder",
                  "CLIP": "encoder/image_encoder",
                  "SmallStem": "encoder/SmallStem_0",
                  "PatchEncoder": "encoder/PatchEncoder_0",
                  "EfficientNet": "encoder/EfficientNet_0",
                  "Siglip": None}


def segment_attention_mask(batch, n_lang, n_patch, n_action, device=None):
    """Boolean (B, 1, L, L) mask over [lang | patches | action] segments:
    full attention, except that language rows only see language columns
    and no row may look at the trailing action tokens
    (hypervla_tpu/models/base_vit.py::_segment_attention_mask)."""
    total = n_lang + n_patch + n_action
    mask = torch.ones((batch, 1, total, total), dtype=torch.bool,
                      device=device)
    if n_lang:
        mask[:, :, :n_lang, n_lang:] = False
    mask[:, :, :total - n_action, total - n_action:] = False
    return mask


def normalize_pixels(images, encoder_type: str = "DINOv2"):
    """uint8 (B, H, W, 3) -> fp32 pixels normalised with the encoder's
    statistics (ImageNet's for DINOv2, CLIP's own)."""
    mean, std = (torch.tensor(s, device=images.device)
                 for s in PIXEL_STATS[encoder_type])
    return (images.float() / 255.0 - mean) / std


def _check_resolution(images, encoder_type: str = "DINOv2"):
    """The JAX ViT's assert on the frame's size, as an AssertionError."""
    expected = EXPECTED_RESOLUTION.get(encoder_type)
    if expected is not None and tuple(images.shape[1:3]) != (expected,
                                                            expected):
        raise AssertionError(
            f"{encoder_type} input must be {expected}x{expected}.")


def trunk_remat(vit_kwargs: dict):
    """The trunk's layer remat: False, True (only layer inputs kept) or a
    policy name of REMAT_SAVED, which overrides remat_dino as in the JAX
    package; an unknown name raises KeyError, as the JAX policy dict does."""
    policy = vit_kwargs.get("dino_remat_policy")
    if policy is not None:
        REMAT_SAVED[policy]  # noqa: B018 (raises KeyError on a bad name)
        return policy
    return bool(vit_kwargs.get("remat_dino", False))


def check_trunk_switches(vit_kwargs: dict) -> None:
    """Raises NotImplementedError for a trunk switch of the JAX package
    (hypervla_tpu/models/base_vit.py) that the port has no counterpart for,
    rather than run the plain trunk without a word, and the JAX package's
    exception for a combination it refuses: AssertionError for the fused
    residual boundaries under remat and for the scanned trunk with
    attention capture, KeyError for an unknown remat policy."""
    kw = vit_kwargs
    layer_norm_fn(kw.get("fused_layer_norm", False))
    impl = kw.get("dino_layers_impl")
    if impl not in (None, "pallas_train", "pallas_serving"):
        raise NotImplementedError(
            f"vit_kwargs dino_layers_impl={impl!r} is not ported (the XLA "
            "scan twins of the serving trunk are not carried: the port has "
            "one plain version, ROADMAP.md queue B's note)")
    remat = trunk_remat(kw)
    scan = kw.get("scan_dino_layers", False)
    if (kw.get("dino_fused_add_ln", False) and remat and not scan
            and impl != "pallas_train"
            and not kw.get("sow_dino_attention", True)):
        raise AssertionError("dino_fused_add_ln is incompatible with layer "
                             "remat (remat_dino, dino_remat_policy)")
    if (kw.get("encoder_type") == "DINOv2" and scan
            and kw.get("sow_dino_attention", True)):
        raise AssertionError("scan_dino_layers cannot capture attention "
                             "maps: set sow_dino_attention=False")
    # dino_dot_softmax is accepted and changes nothing: it only re-lays the
    # softmax sums out for the TPU's matrix unit, the same values up to rounding


class ViT:
    """Config holder + forward of the policy ViT.

    input_shapes give the shapes the param table depends on:
    "image" (H, W) of the frames (DINOv2 takes 224 x 224 only) and, with
    use_language_token, "instruction" (L, token_dim) of the instruction's
    token embedding."""

    def __init__(self, vit_kwargs: dict, action_token_num: int,
                 input_shapes: Optional[dict] = None):
        kw = vit_kwargs
        self.encoder_type = kw.get("encoder_type", "SmallStem")
        if self.encoder_type not in ENCODER_PREFIX:
            raise NotImplementedError(
                f"Unknown encoder type {self.encoder_type} for ViT")
        self.differential = bool(kw.get("use_differential_transformer",
                                        False))
        check_trunk_switches(kw)
        self.prefix = ENCODER_PREFIX[self.encoder_type]
        self.dropout_rate = kw.get("dropout_rate", 0.0) or 0.0
        self.image_embedding_noise = float(kw.get("image_embedding_noise",
                                                  0.0))
        self.return_attention_map = kw.get("return_attention_map", False)
        self.hidden_dim = kw["hidden_dim"]
        self.num_layers = kw["num_layers"]
        self.num_heads = kw["num_heads"]
        self.mlp_dim = kw["mlp_dim"]
        self.action_token_num = action_token_num
        self.use_language_token = kw.get("use_language_token", False)
        self.add_positional_embedding = kw.get("add_positional_embedding",
                                               True)
        self.include_class_token = kw.get("include_class_token", False)
        shapes = dict(input_shapes or {})
        self.image_shape = tuple(shapes.get("image",
                                            (RESOLUTION, RESOLUTION)))
        self.instruction_shape = (tuple(shapes["instruction"])
                                  if "instruction" in shapes else None)
        self.embedding_shape = (tuple(shapes["patch_embeddings"])
                                if "patch_embeddings" in shapes else None)
        self.encoder_dtype = str(kw.get("encoder_dtype", "float32"))
        self.fine_tune = kw.get("fine_tune_pretrained_image_encoder", False)
        self.stem = None
        self.dino = None
        self.clip = None
        self.efficientnet = None
        self.capture = False
        if self.encoder_type == "SmallStem":
            self.stem = SmallStem(patch_size=kw.get("patch_size", 16),
                                  num_features=self.hidden_dim,
                                  features=tuple(kw.get(
                                      "cnn_channels", (32, 96, 192, 384))))
        elif self.encoder_type == "PatchEncoder":
            self.stem = PatchEncoder(patch_size=kw.get("patch_size", 16),
                                     num_features=self.hidden_dim)
        elif self.encoder_type == "CLIP":
            self.clip = CLIPVisionModel(clip_vision_config(CLIP_NAME))
        elif self.encoder_type == "EfficientNet":
            self.efficientnet = EfficientNet(MODEL_CONFIGS[EFFICIENTNET_NAME])
        elif self.encoder_type == "DINOv2":
            self._init_trunk(kw)
        self.n_patch = self._num_patches()

    def _init_trunk(self, kw: dict) -> None:
        """The DINOv2 trunk's geometry and switches."""
        self.dino = dinov2_config(kw.get("pretrained_encoder_name",
                                         "dinov2-base"))
        # the JAX trunk takes the fused attention, the forward-only flash
        # attention (ops/flash_attention.py) and the fused residual
        # boundaries (ops/add_layer_norm.py) only when it does not capture
        # attention maps (sow_dino_attention defaults to on)
        capture = kw.get("sow_dino_attention", True)
        self.capture = capture
        # the JAX scanned stack builds its layers without the fused
        # attention, the fused residual boundaries and remat
        self.scan = kw.get("scan_dino_layers", False)
        self.fused_attention = (kw.get("dino_fused_attention", False)
                                and not capture and not self.scan)
        self.use_flash = kw.get("use_flash_attention", False) and not capture
        # with use_flash, the differentiable flash attention in place of
        # the forward-only one (ops/flash_attention_train.py)
        self.flash_trainable = kw.get("flash_attention_trainable", False)
        self.fused_add_ln = (kw.get("dino_fused_add_ln", False)
                             and not capture and not self.scan)
        self.remat = False if self.scan else trunk_remat(kw)
        # the trunk's layers as the differentiable layer kernel
        # (ops/dino_layer_train.py; it wins over fused_add_ln), and the
        # LayerNorm choice
        self.layer_kernel = kw.get("dino_layers_impl") == "pallas_train"
        self.fused_ln = kw.get("fused_layer_norm", False)
        if self.layer_kernel and not self.bf16_trunk:
            raise ValueError("dino_layers_impl='pallas_train' is a bf16 "
                             "kernel: set encoder_dtype='bfloat16'")

    def _num_patches(self) -> int:
        if self.stem is not None:
            return self.stem.num_tokens(*self.image_shape)
        if self.clip is not None:
            return (RESOLUTION // self.clip.config.patch_size) ** 2
        if self.efficientnet is not None:
            height, width = self.image_shape
            return (output_side(height, self.efficientnet.config)
                    * output_side(width, self.efficientnet.config))
        if self.encoder_type == "Siglip":
            return self._siglip_shape()[0]
        return ((RESOLUTION // self.dino.patch_size) ** 2
                + int(self.include_class_token))

    def _siglip_shape(self):
        """(tokens, dim) of the precomputed embeddings; the JAX base net
        indexes them out of the example batch at init (IndexError without
        them)."""
        if self.embedding_shape is None:
            raise IndexError("a Siglip ViT reads its patch embeddings from "
                             "the batch: pass input_shapes["
                             "'patch_embeddings'] (the example batch's "
                             "observation patch_embeddings)")
        return self.embedding_shape

    @property
    def has_trunk(self) -> bool:
        """Whether the image encoder is the shared DINOv2 trunk."""
        return self.dino is not None

    @property
    def batched_encoder(self) -> bool:
        """Whether the image encoder is a shared pretrained trunk (DINOv2
        or CLIP) that the train step runs once over the whole batch (the
        JAX package's hoisted trunk)."""
        return self.dino is not None or self.clip is not None

    @property
    def embedding_dim(self) -> int:
        """The width of the patch embeddings the projection reads."""
        if self.clip is not None:
            return self.clip.config.hidden_size
        if self.encoder_type == "Siglip":
            return self._siglip_shape()[1]
        return self.dino.hidden_size

    @property
    def bf16_trunk(self) -> bool:
        return self.has_trunk and self.encoder_dtype in ("bfloat16", "bf16")

    @property
    def n_lang(self) -> int:
        if not self.use_language_token:
            return 0
        if self.instruction_shape is None:
            raise ValueError("use_language_token needs the instruction's "
                             "shape: pass input_shapes['instruction']")
        return self.instruction_shape[0]

    def _trunk_switches(self) -> dict:
        return dict(fused_attention=self.fused_attention,
                    layer_kernel=self.layer_kernel, fused_ln=self.fused_ln,
                    use_flash=self.use_flash,
                    flash_trainable=self.flash_trainable,
                    fused_add_ln=self.fused_add_ln)

    def _drop_class_token(self, emb):
        return emb if self.include_class_token else emb[:, 1:]

    def image_embeddings(self, params: Dict[str, torch.Tensor], images,
                         trunk_impl: str = "kernel",
                         attentions: Optional[list] = None):
        """uint8 (B, 224, 224, 3) -> DINOv2 patch embeddings (fp32). A bf16
        trunk runs over params prepared by ops/serving.py: the stacked trunk
        (trunk_impl "kernel", or "reference" for its plain version), or,
        with "layers", the layer loop over the bf16-stored per-layer leaves
        under the trunk switches of the config, as the JAX serving step does
        without its trunk kernel ("layers_reference": the same with the
        plain versions of the forward-only serving kernels). An fp32 trunk
        always runs the layer loop. attentions (a list; the layer loop,
        with sow_dino_attention) receives each layer's attention
        probabilities."""
        enc = subtree(params, "encoder/image_encoder/")
        if self.clip is not None:
            return self.clip(enc, normalize_pixels(images, "CLIP")
                             ).last_hidden_state[:, 1:]
        pixels = normalize_pixels(images)
        if attentions is not None and not self.capture:
            raise ValueError("the trunk captures attention maps only with "
                             "vit_kwargs sow_dino_attention")
        if (self.bf16_trunk and trunk_impl in ("kernel", "reference")
                and attentions is None):
            emb = dinov2_serving_forward(self.dino, enc, pixels, trunk_impl)
        else:
            dtype = torch.bfloat16 if self.bf16_trunk else torch.float32
            emb = dinov2_forward(self.dino, enc, pixels, dtype,
                                 plain=trunk_impl == "layers_reference",
                                 attentions=attentions,
                                 **self._trunk_switches())
        return self._drop_class_token(emb)

    def train_image_embeddings(self, trunk_params: Dict[str, torch.Tensor],
                               images, draws: Optional[Draws] = None):
        """uint8 (B, 224, 224, 3) -> patch embeddings (fp32) from the
        differentiable training trunk over per-layer params (keys under
        encoder/image_encoder/, prefix removed), in the encoder dtype, under
        the trunk switches of the config (the fused training attention, the
        layer kernel, the LayerNorm choice, the fused residual boundaries,
        layer remat). With draws (a training forward), image_embedding_noise
        adds noise * N(0, 1) to each sample's embeddings. A CLIP trunk runs
        its plain fp32 forward (the JAX CLIP path adds no noise)."""
        _check_resolution(images, self.encoder_type)
        if self.clip is not None:
            return self.clip(trunk_params, normalize_pixels(images, "CLIP")
                             ).last_hidden_state[:, 1:]
        dtype = torch.bfloat16 if self.bf16_trunk else torch.float32
        emb = dinov2_forward(self.dino, trunk_params, normalize_pixels(images),
                             dtype, remat=self.remat,
                             **self._trunk_switches())
        emb = self._drop_class_token(emb)
        if draws is not None and self.image_embedding_noise > 0:
            emb = emb + self.image_embedding_noise * draws.normal(
                "embedding_noise", emb.shape, emb.device)
        return emb

    def _patches(self, params, images, trunk_impl, image_embeddings,
                 draws=None, train=False):
        """(B, n_patch, hidden_dim) patch tokens."""
        if images is not None:
            _check_resolution(images, self.encoder_type)
        if self.stem is not None:
            return self.stem(params, self.prefix, images)
        if self.efficientnet is not None:
            features = self.efficientnet(
                params, self.prefix, normalize_images(images), train=train,
                draws=draws)
            patches = conv_same(features, params["encoder/Conv_0/kernel"],
                                params["encoder/Conv_0/bias"])
            return patches.reshape(patches.shape[0], -1, self.hidden_dim)
        emb = image_embeddings
        if self.encoder_type == "Siglip":
            if emb is None:
                raise ValueError("a Siglip ViT reads precomputed patch "
                                 "embeddings: pass image_embeddings")
            emb = emb.float()
        elif emb is None:
            emb = self.image_embeddings(params, images, trunk_impl)
        if not self.fine_tune and self.encoder_type != "Siglip":
            emb = emb.detach()
        return layers.dense(
            emb, params["encoder/image_embedding_projection/kernel"],
            params["encoder/image_embedding_projection/bias"])

    def __call__(self, params: Dict[str, torch.Tensor], images=None,
                 trunk_impl: str = "kernel", image_embeddings=None,
                 instruction_embeddings=None, draws: Optional[Draws] = None,
                 maps: Optional[dict] = None):
        """Readout embeddings (B, action_token_num, hidden_dim) from uint8
        images (B, H, W, 3), or, on the DINOv2 path, from patch embeddings
        computed outside (the training step's batched trunk).
        instruction_embeddings (B, L, token_dim) feed the language tokens.
        params may carry a leading per-sample axis
        (models/hypernetwork.py::per_sample_view). draws: the training
        forward's dropout. maps (a dict) receives "policy", every
        transformer block's attention probabilities (B, heads, L, L), and,
        where the trunk runs here and captures, "dino", its layers'."""
        if (maps is not None and self.has_trunk and self.capture
                and image_embeddings is None):
            _check_resolution(images)
            maps["dino"] = []
            emb = self.image_embeddings(params, images, trunk_impl,
                                        maps["dino"])
            patches = self._patches(params, images, trunk_impl, emb)
        else:
            patches = self._patches(params, images, trunk_impl,
                                    image_embeddings, draws,
                                    train=draws is not None)
        batch = patches.shape[0]
        n_lang = 0
        if self.use_language_token:
            if instruction_embeddings is None:
                raise ValueError("use_language_token: pass the "
                                 "instruction's token embeddings")
            lang = layers.dense(
                instruction_embeddings.float(),
                params["encoder/language_token_projection/kernel"],
                params["encoder/language_token_projection/bias"])
            n_lang = lang.shape[1]
            patches = torch.cat([lang, patches], dim=1)
        pos = params["encoder/pos_embedding"]
        if self.add_positional_embedding:
            x = torch.cat([patches, patches.new_zeros(
                batch, self.action_token_num, self.hidden_dim)], dim=1)
            x = x + pos
        else:
            # only the action tokens get (learned) positions; the others
            # get zeros, which leave them as they are
            x = torch.cat([patches, pos.expand(
                batch, self.action_token_num, self.hidden_dim)], dim=1)
        x = dropout(x, self.dropout_rate, draws, "encoder/Dropout_0")
        mask = segment_attention_mask(batch, n_lang,
                                      patches.shape[1] - n_lang,
                                      self.action_token_num, x.device)
        if maps is not None:
            maps["policy"] = []
        x = transformer(params, "encoder/Transformer_0", x, mask,
                        self.num_layers, self.num_heads, self.dropout_rate,
                        0.0, draws=draws,
                        maps=None if maps is None else maps["policy"],
                        use_differential_transformer=self.differential)
        return x[:, -self.action_token_num:]

    def specs(self) -> Dict[str, Tuple[tuple, layers.Init]]:
        """Param shapes and initializers under encoder/."""
        n_pos = self.action_token_num
        if self.add_positional_embedding:
            n_pos += self.n_lang + self.n_patch
        specs = {"encoder/pos_embedding": (
            (1, n_pos, self.hidden_dim), layers.normal(0.02))}
        if self.stem is not None:
            specs.update(self.stem.specs(self.prefix))
        elif self.efficientnet is not None:
            specs.update(self.efficientnet.specs(self.prefix))
            specs.update({
                "encoder/Conv_0/bias": ((self.hidden_dim,), layers.zeros),
                "encoder/Conv_0/kernel": (
                    (1, 1, self.efficientnet.features, self.hidden_dim),
                    layers.lecun_normal),
            })
        else:
            specs.update({
                "encoder/image_embedding_projection/bias": (
                    (self.hidden_dim,), layers.zeros),
                "encoder/image_embedding_projection/kernel": (
                    (self.embedding_dim, self.hidden_dim),
                    layers.lecun_normal),
            })
            if self.clip is not None:
                specs.update(self.clip.specs(self.prefix))
            elif self.dino is not None:
                specs.update(dinov2_specs(self.dino, "encoder/image_encoder"))
        if self.use_language_token:
            specs.update({
                "encoder/language_token_projection/bias": (
                    (self.hidden_dim,), layers.zeros),
                "encoder/language_token_projection/kernel": (
                    (self.instruction_shape[1], self.hidden_dim),
                    layers.lecun_normal),
            })
        specs.update(transformer_specs(
            "encoder/Transformer_0", self.hidden_dim, self.num_layers,
            self.mlp_dim, self.num_heads,
            use_differential_transformer=self.differential))
        return specs
