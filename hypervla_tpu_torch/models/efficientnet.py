"""The EfficientNet backbone, b0-b7 (counterpart of
hypervla_tpu/models/efficientnet.py).

As in the JAX package, batch norm is a LayerNorm over channels (eps 1e-6),
so the backbone keeps no statistics. The stage table resolves into a flat
per-block plan (`expand_block_plan`) before anything runs. Convolutions pad
as XLA's "SAME" does, the odd pixel on the high side at stride 2
(models/layers.py::pad_same; torch's padding="same" takes stride 1 only). The
depthwise kernels keep the JAX layout (kh, kw, C, 1) and run as a
convolution of C groups. Activations run NHWC; every convolution lays its
input out NCHW for torch and back.

Params keep the flax names under the backbone's prefix: Stem_0/{conv2d,
LayerNorm_0}, MBConvBlock_<i>/{expand_conv2d_0, depthwise_conv2d/
depthwise_kernel, SqueezeExcite_0/{reduce_conv2d_0, expand_conv2d_0,
LayerNorm_0, LayerNorm_1}, project_conv2d_0, LayerNorm_<j>}, Head_0/{conv2d,
LayerNorm_0}. A block's params may carry a leading per-sample axis (a
generated backbone, models/hypernetwork.py::per_sample_view): the
convolutions then group by sample.

Stochastic depth drops a block's residual branch per sample in training
(given a models/draws.py::Draws), at the block's module path
"<prefix>/MBConvBlock_<i>", a (B, 1, 1, 1) keep mask, as the JAX block
draws it from its "drop_connect" stream under the train step's
per-sample vmap. The JAX block takes a key from that stream before it
looks at `train`, so a forward without the stream fails there, in
evaluation too (InvalidRngError): a forward here without draws raises
`InvalidRngError` at the first block that could drop its branch.
"""
import math
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from hypervla_tpu_torch.models import layers
from hypervla_tpu_torch.models.draws import Draws, InvalidRngError

MEAN_RGB = [0.485, 0.456, 0.406]
STDDEV_RGB = [0.229, 0.224, 0.225]


@dataclass
class BlockConfig:
    """One MBConv stage before depth/width scaling."""

    input_filters: int = 0
    output_filters: int = 0
    kernel_size: int = 3
    num_repeat: int = 1
    expand_ratio: int = 1
    strides: Tuple[int, int] = (1, 1)
    se_ratio: Optional[float] = None
    id_skip: bool = True
    fused_conv: bool = False
    conv_type: str = "depthwise"
    drop_rate: float = 0.0  # filled in by expand_block_plan


# the EfficientNet-B0 stage table every variant scales from
_B0_STAGES = (
    # in, out, kernel, repeat, expand, strides, se
    (32, 16, 3, 1, 1, (1, 1), 0.25),
    (16, 24, 3, 2, 6, (2, 2), 0.25),
    (24, 40, 5, 2, 6, (2, 2), 0.25),
    (40, 80, 3, 3, 6, (2, 2), 0.25),
    (80, 112, 5, 3, 6, (1, 1), 0.25),
    (112, 192, 5, 4, 6, (2, 2), 0.25),
    (192, 320, 3, 1, 6, (1, 1), 0.25),
)


def _b0_blocks():
    return tuple(BlockConfig(i, o, k, r, e, s, se)
                 for i, o, k, r, e, s, se in _B0_STAGES)


@dataclass
class ModelConfig:
    """Model-level configuration (defaults: EfficientNet-B0)."""

    width_coefficient: float = 1.0
    depth_coefficient: float = 1.0
    resolution: int = 224
    dropout_rate: float = 0.2
    blocks: Tuple[BlockConfig, ...] = field(default_factory=_b0_blocks)
    stem_base_filters: int = 32
    top_base_filters: int = 1280
    activation: str = "swish"
    batch_norm: str = "default"
    bn_momentum: float = 0.99
    bn_epsilon: float = 1e-3
    weight_decay: float = 5e-6
    drop_connect_rate: float = 0.2
    depth_divisor: int = 8
    min_depth: Optional[int] = None
    use_se: bool = True
    input_channels: int = 3
    num_classes: int = 1000
    model_name: str = "efficientnet"
    rescale_input: bool = True
    data_format: str = "channels_last"
    final_projection_size: int = 0
    classifier_head: bool = True
    dtype: Any = torch.float32


def _scaled_variant(width, depth, res, dropout):
    return ModelConfig(width_coefficient=width, depth_coefficient=depth,
                       resolution=res, dropout_rate=dropout)


MODEL_CONFIGS = {
    f"efficientnet-b{i}": _scaled_variant(*spec)
    for i, spec in enumerate([
        (1.0, 1.0, 224, 0.2),
        (1.0, 1.1, 240, 0.2),
        (1.1, 1.2, 260, 0.3),
        (1.2, 1.4, 300, 0.3),
        (1.4, 1.8, 380, 0.4),
        (1.6, 2.2, 456, 0.4),
        (1.8, 2.6, 528, 0.5),
        (2.0, 3.1, 600, 0.5),
    ])
}


def round_filters(filters: int, config: ModelConfig) -> int:
    """Width scaling, snapped to the depth divisor (never dropping more
    than 10%)."""
    if not config.width_coefficient:
        return filters
    divisor = config.depth_divisor
    scaled = filters * config.width_coefficient
    floor = config.min_depth or divisor
    snapped = max(floor, int(scaled + divisor / 2) // divisor * divisor)
    if snapped < 0.9 * scaled:
        snapped += divisor
    return int(snapped)


def round_repeats(repeats: int, depth_coefficient: float) -> int:
    return int(math.ceil(depth_coefficient * repeats))


def expand_block_plan(config: ModelConfig) -> Sequence[BlockConfig]:
    """The stage table resolved into the full per-block sequence: width
    scaling applied, repeats unrolled (a stage's repeats after the first
    at stride 1 with input = output), the stochastic-depth rate ramped
    linearly over the block index."""
    total = sum(round_repeats(b.num_repeat, config.depth_coefficient)
                for b in config.blocks)
    plan, idx = [], 0
    for stage in config.blocks:
        assert stage.num_repeat > 0
        resolved = replace(
            stage,
            input_filters=round_filters(stage.input_filters, config),
            output_filters=round_filters(stage.output_filters, config),
            num_repeat=round_repeats(stage.num_repeat,
                                     config.depth_coefficient))
        for rep in range(resolved.num_repeat):
            block = replace(resolved,
                            drop_rate=config.drop_connect_rate * idx / total)
            if rep > 0:
                block = replace(block, input_filters=block.output_filters,
                                strides=(1, 1))
            plan.append(block)
            idx += 1
    return plan


def _channels(v):
    """A per-channel vector, (C,) shared or (B, 1, C) per sample, laid out
    to broadcast over NHWC activations."""
    return v if v.dim() == 1 else v.reshape(v.shape[0], 1, 1, -1)


def conv_same(x, kernel, bias=None, stride: int = 1, groups: int = 1):
    """flax's NHWC convolution with "SAME" padding: x (B, H, W, C_in),
    kernel HWIO (kh, kw, C_in / groups, C_out), or per sample with a
    leading B axis (models/layers.py::conv2d)."""
    kh, kw = kernel.shape[-4:-2]
    y = layers.conv2d(layers.pad_same(x.permute(0, 3, 1, 2), kh, kw, stride),
                      kernel, bias, stride, groups=groups)
    return y.permute(0, 2, 3, 1)


def depthwise_conv(x, kernel, stride: int = 1):
    """DepthwiseConv: kernel (kh, kw, C, 1), or per sample (B, kh, kw, C,
    1) (models/hypernetwork.py::per_sample_view gives a generated one a
    singleton after the sample axis, which is dropped), one output channel
    per input channel."""
    if kernel.dim() == 6:
        kernel = kernel.squeeze(1)
    return conv_same(x, kernel.transpose(-2, -1), stride=stride,
                     groups=x.shape[-1])


_ACTIVATIONS = {"swish": F.silu, "silu": F.silu, "sigmoid": torch.sigmoid,
                "relu": torch.relu}


def _conv_ln_act(params, prefix: str, norm: str, x, *, stride: int = 1,
                 depthwise: bool = False, activation: Optional[str] = None):
    """conv (`prefix`) -> LayerNorm (`norm`, the batch-norm replacement)
    -> optional activation."""
    if depthwise:
        x = depthwise_conv(x, params[f"{prefix}/depthwise_kernel"], stride)
    else:
        x = conv_same(x, params[f"{prefix}/kernel"],
                      params.get(f"{prefix}/bias"), stride)
    x = layers.layer_norm(x, _channels(params[f"{norm}/scale"]),
                          _channels(params[f"{norm}/bias"]))
    if activation is not None:
        x = _ACTIVATIONS[activation.lower()](x)
    return x


def stochastic_depth(inputs, keep, survival_probability: float):
    """Drops the whole residual branch where `keep` ((B, 1, 1, 1) bool)
    is False, scaling the kept ones by 1 / survival_probability."""
    return torch.where(keep, inputs / survival_probability,
                       torch.zeros_like(inputs))


class SqueezeExcite:
    """Global pool -> bottleneck -> sigmoid gate over channels."""

    def __init__(self, num_filters: int, block: BlockConfig,
                 config: ModelConfig):
        self.num_filters = num_filters
        self.block = block
        self.config = config

    @property
    def reduced(self) -> int:
        return max(1, int(self.block.input_filters * self.block.se_ratio))

    def __call__(self, params, prefix: str, inputs):
        gate = inputs.mean((1, 2), keepdim=True)
        gate = _conv_ln_act(params, f"{prefix}/reduce_conv2d_0",
                            f"{prefix}/LayerNorm_0", gate,
                            activation=self.config.activation)
        gate = _conv_ln_act(params, f"{prefix}/expand_conv2d_0",
                            f"{prefix}/LayerNorm_1", gate,
                            activation="sigmoid")
        return inputs * gate

    def specs(self, prefix: str, in_filters: int):
        specs = {}
        for i, (name, fin, fout) in enumerate((
                ("reduce_conv2d_0", in_filters, self.reduced),
                ("expand_conv2d_0", self.reduced, self.num_filters))):
            specs.update(_conv_specs(f"{prefix}/{name}", 1, fin, fout,
                                     bias=True))
            specs.update(_norm_specs(f"{prefix}/LayerNorm_{i}", fout))
        return specs


def _conv_init(shape, gen):
    """variance_scaling(2.0, "fan_out", "normal"), the JAX conv init (the
    fan-out is the last axis times the receptive field)."""
    fan_out = shape[-1] * math.prod(shape[:-2])
    return torch.randn(tuple(shape), generator=gen) * math.sqrt(2.0 / fan_out)


def _conv_specs(prefix, size, fin, fout, bias=False, depthwise=False):
    if depthwise:
        return {f"{prefix}/depthwise_kernel": ((size, size, fin, 1),
                                               _conv_init)}
    specs = {f"{prefix}/kernel": ((size, size, fin, fout), _conv_init)}
    if bias:
        specs[f"{prefix}/bias"] = ((fout,), layers.zeros)
    return specs


def _norm_specs(prefix, channels):
    return {f"{prefix}/bias": ((channels,), layers.zeros),
            f"{prefix}/scale": ((channels,), layers.ones)}


class MBConvBlock:
    """Mobile inverted bottleneck: expand -> depthwise -> SE -> project,
    with a stochastically dropped identity skip where the shapes allow."""

    def __init__(self, block: BlockConfig, config: ModelConfig,
                 train: bool = False):
        self.block = block
        self.config = config
        self.train = train

    def _layout(self):
        """[(kind, conv name, kernel size, stride, in, out)] in the order
        the JAX block runs its conv + LayerNorm pairs (LayerNorm_<j> is the
        j-th), before the squeeze-excite."""
        blk = self.block
        depthwise = blk.conv_type != "no_depthwise"
        expanded = blk.input_filters * blk.expand_ratio
        stride = blk.strides[0]
        out = []
        if blk.fused_conv:
            out.append(("conv", "fused_conv2d_0", blk.kernel_size, stride,
                        blk.input_filters, expanded))
        else:
            if blk.expand_ratio != 1:
                out.append(("conv", "expand_conv2d_0",
                            1 if depthwise else 3, 1, blk.input_filters,
                            expanded))
            if depthwise:
                out.append(("depthwise", "depthwise_conv2d", blk.kernel_size,
                            stride, expanded, expanded))
        return out, expanded

    def __call__(self, params, prefix: str, inputs,
                 draws: Optional[Draws] = None):
        blk, cfg = self.block, self.config
        pre, expanded = self._layout()
        x = inputs
        for j, (kind, name, _, stride, _, _) in enumerate(pre):
            x = _conv_ln_act(params, f"{prefix}/{name}",
                             f"{prefix}/LayerNorm_{j}", x, stride=stride,
                             depthwise=kind == "depthwise",
                             activation=cfg.activation)
        if cfg.use_se:
            assert blk.se_ratio is not None and 0 < blk.se_ratio <= 1
            x = SqueezeExcite(expanded, blk, cfg)(
                params, f"{prefix}/SqueezeExcite_0", x)
        x = _conv_ln_act(params, f"{prefix}/project_conv2d_0",
                         f"{prefix}/LayerNorm_{len(pre)}", x)
        can_skip = (blk.id_skip and all(s == 1 for s in blk.strides)
                    and blk.input_filters == blk.output_filters)
        if can_skip:
            if blk.drop_rate > 0 and draws is None:
                # the JAX block asks its "drop_connect" stream for a key
                # before it looks at `train`
                raise InvalidRngError(
                    f'{prefix.split("/")[-1]} needs PRNG for "drop_connect"')
            if blk.drop_rate > 0 and self.train:
                survival = 1 - blk.drop_rate
                keep = draws.keep_mask(prefix, (x.shape[0], 1, 1, 1),
                                       survival, x.device)
                x = stochastic_depth(x, keep, survival)
            x = x + inputs
        return x

    def specs(self, prefix: str):
        blk = self.block
        pre, expanded = self._layout()
        specs = {}
        for j, (kind, name, size, _, fin, fout) in enumerate(pre):
            specs.update(_conv_specs(f"{prefix}/{name}", size, fin, fout,
                                     depthwise=kind == "depthwise"))
            specs.update(_norm_specs(f"{prefix}/LayerNorm_{j}", fout))
        if self.config.use_se:
            specs.update(SqueezeExcite(expanded, blk, self.config).specs(
                f"{prefix}/SqueezeExcite_0", expanded))
        specs.update(_conv_specs(f"{prefix}/project_conv2d_0", 1, expanded,
                                 blk.output_filters))
        specs.update(_norm_specs(f"{prefix}/LayerNorm_{len(pre)}",
                                 blk.output_filters))
        return specs


class Stem:
    def __init__(self, config: ModelConfig, train: bool = False):
        self.config = config
        self.train = train

    @property
    def features(self) -> int:
        return round_filters(self.config.stem_base_filters, self.config)

    def __call__(self, params, prefix: str, inputs):
        return _conv_ln_act(params, f"{prefix}/conv2d",
                            f"{prefix}/LayerNorm_0", inputs, stride=2,
                            activation=self.config.activation)

    def specs(self, prefix: str):
        specs = _conv_specs(f"{prefix}/conv2d", 3,
                            self.config.input_channels, self.features)
        specs.update(_norm_specs(f"{prefix}/LayerNorm_0", self.features))
        return specs


class Head:
    def __init__(self, config: ModelConfig, train: bool = True):
        self.config = config
        self.train = train

    @property
    def features(self) -> int:
        return round_filters(self.config.top_base_filters, self.config)

    def __call__(self, params, prefix: str, inputs):
        return _conv_ln_act(params, f"{prefix}/conv2d",
                            f"{prefix}/LayerNorm_0", inputs,
                            activation=self.config.activation)

    def specs(self, prefix: str, in_filters: int):
        specs = _conv_specs(f"{prefix}/conv2d", 1, in_filters,
                            self.features)
        specs.update(_norm_specs(f"{prefix}/LayerNorm_0", self.features))
        return specs


class EfficientNet:
    """The backbone over a flat param dict: NHWC inputs (B, H, W, 3) ->
    features (B, H / 32, W / 32, Head's width), rounded up as "SAME"
    does."""

    def __init__(self, config: ModelConfig, dtype: Any = torch.float32):
        self.config = config
        self.dtype = dtype

    def __call__(self, params: Dict[str, torch.Tensor], prefix: str, inputs,
                 *, train: bool, draws: Optional[Draws] = None):
        """draws: the training forward's stochastic depth (with train)."""
        cfg = replace(self.config, dtype=self.dtype)
        x = Stem(cfg, train)(params, f"{prefix}/Stem_0",
                             inputs.to(self.dtype))
        for i, block in enumerate(expand_block_plan(cfg)):
            x = MBConvBlock(block, cfg, train)(
                params, f"{prefix}/MBConvBlock_{i}", x, draws)
        return Head(self.config, train)(params, f"{prefix}/Head_0", x)

    @property
    def features(self) -> int:
        return Head(self.config).features

    def specs(self, prefix: str) -> Dict[str, Tuple[tuple, layers.Init]]:
        specs = Stem(self.config).specs(f"{prefix}/Stem_0")
        plan = expand_block_plan(self.config)
        for i, block in enumerate(plan):
            specs.update(MBConvBlock(block, self.config).specs(
                f"{prefix}/MBConvBlock_{i}"))
        specs.update(Head(self.config).specs(f"{prefix}/Head_0",
                                             plan[-1].output_filters))
        return specs


def output_side(side: int, config: ModelConfig) -> int:
    """The feature map's side for a frame side: the stem and every stride-2
    block halve it, rounding up ("SAME")."""
    for stride in [2] + [b.strides[0] for b in expand_block_plan(config)]:
        side = -(-side // stride)
    return side
