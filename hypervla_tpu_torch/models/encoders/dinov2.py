"""DINOv2 vision encoder (counterpart of
hypervla_tpu/models/encoders/dinov2.py).

Params keep the JAX package's (HF-compatible) tree: embeddings/{cls_token,
mask_token, position_embeddings, patch_embeddings/projection/{kernel,bias}},
encoder/layer/<i>/..., layernorm/{scale,bias}, with the patch kernel in
nn.Conv's (kh, kw, cin, cout) layout applied as one GEMM over patches.

Two layer paths, as in the JAX package:
  * `dinov2_forward` runs the layer loop in fp32 (goldens, tiny configs,
    the once-per-episode encode of the initial image) or bf16 (the
    differentiable training trunk, with the fused training attention as an
    option, or with every layer through the differentiable layer kernel of
    ops/dino_layer_train.py; the frozen conditioning encoder, whose layers
    may go through that kernel's no-residual forward on operands packed
    once; the serving step's per-layer trunk over bf16-stored weights). Its
    LayerNorms follow `fused_ln`, the training LayerNorm and the one-pass
    serving LayerNorm of ops/layer_norm.py among the choices; `use_flash`
    runs attention through the forward-only kernel of
    ops/flash_attention.py; `fused_add_ln` runs every residual boundary
    (LayerScale multiply, add, the next LayerNorm) through
    ops/add_layer_norm.py; with HYPERVLA_FUSED_GELU=1 in the environment a
    large bf16 GELU goes through ops/gelu.py. `attentions` returns every
    layer's attention probabilities (the JAX trunk's output_attentions,
    on the einsum route only); `remat` recomputes each layer's activations
    in the backward (torch.utils.checkpoint, as the JAX package's nn.remat
    with its `_remat_policy`);
  * `dinov2_serving_forward` runs the bf16 embeddings, the stacked serving
    trunk (ops/dino_layer.py: the CUDA kernels on the card) and the final
    LayerNorm, over params prepared by ops/serving.py.
"""
import functools
import math
import os
from typing import Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from hypervla_tpu_torch.configs import DINOv2Config
from hypervla_tpu_torch.models import layers
from hypervla_tpu_torch.ops import dino_layer, dino_layer_train
from hypervla_tpu_torch.ops import fused_attention as fused_attention_op
from hypervla_tpu_torch.ops.add_layer_norm import fused_add_scale_ln
from hypervla_tpu_torch.ops.flash_attention import (
    mha_flash,
    mha_flash_reference,
)
from hypervla_tpu_torch.ops.gelu import gelu_exact_fused
from hypervla_tpu_torch.ops.layer_norm import layer_norm as layer_norm_one_pass
from hypervla_tpu_torch.ops.layer_norm import (
    layer_norm_pallas,
    layer_norm_reference,
)


# ----------------------- position-grid interpolation -----------------------


def _keys_cubic(x):
    """Keys cubic kernel (a = -0.5), as jax.image uses for "bicubic"."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _lanczos3(x):
    y = 3.0 * torch.sin(math.pi * x) * torch.sin(math.pi * x / 3.0)
    denom = torch.where(x != 0, math.pi ** 2 * x ** 2, torch.ones_like(x))
    out = torch.where(x > 1e-3, y / denom, torch.ones_like(x))
    return torch.where(x > 3.0, torch.zeros_like(x), out)


def _triangle(x):
    return torch.clamp(1.0 - x.abs(), min=0.0)


KERNELS = {"bicubic": _keys_cubic, "lanczos3": _lanczos3,
           "bilinear": _triangle}


def scale_translate_weights(in_size: int, out_size: int, scale: float,
                            translation: float, method: str, antialias: bool,
                            device=None, f32_scale: bool = True):
    """The (in_size, out_size) resampling matrix of
    jax.image.scale_and_translate along one axis (jax's
    compute_weight_mat, in fp32): half-pixel centres, the kernel widened by
    1/scale when antialiasing a downsample, columns normalised to sum 1,
    samples outside the input zeroed. With f32_scale the scale is rounded
    to fp32 before its inverse is taken (a jnp.float32 scale, as in
    scale_and_translate); without, the inverse is taken in double (a Python
    float scale, as in jax.image.resize)."""
    f32 = torch.float32
    if f32_scale:
        inv_scale = 1.0 / torch.tensor(scale, dtype=f32, device=device)
    else:
        inv_scale = torch.tensor(1.0 / scale, dtype=f32, device=device)
    kernel_scale = torch.clamp(inv_scale, min=1.0) if antialias else 1.0
    trans = torch.tensor(translation, dtype=f32, device=device)
    sample_f = ((torch.arange(out_size, dtype=f32, device=device) + 0.5)
                * inv_scale - trans * inv_scale - 0.5)
    x = (sample_f[None, :] - torch.arange(in_size, dtype=f32,
                                          device=device)[:, None]).abs()
    weights = KERNELS[method](x / kernel_scale)
    total = weights.sum(0, keepdim=True)
    eps = 1000.0 * float(torch.finfo(f32).eps)
    weights = torch.where(
        total.abs() > eps,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights),
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def interpolate_pos_encoding(config: DINOv2Config, position_embeddings,
                             height: int, width: int):
    """Bicubic scale_and_translate of the trained position grid onto the
    (height, width) patch grid, with HF's +0.1 in the target extent and
    antialias off. Returns fp32 (1, 1 + h*w, dim)."""
    pos = position_embeddings.float()
    num_positions = pos.shape[1] - 1
    h, w = height // config.patch_size, width // config.patch_size
    if h * w == num_positions and height == width:
        return pos
    src = int(math.sqrt(num_positions))
    dim = pos.shape[-1]
    grid = pos[0, 1:].reshape(src, src, dim)
    wy = scale_translate_weights(src, h, (h + 0.1) / src, 0.0, "bicubic",
                                 False, pos.device)
    wx = scale_translate_weights(src, w, (w + 0.1) / src, 0.0, "bicubic",
                                 False, pos.device)
    out = torch.einsum("ijd,ia,jb->abd", grid, wy, wx).reshape(1, h * w, dim)
    return torch.cat([pos[:, :1], out], dim=1)


# ------------------------------- embeddings -------------------------------


def embeddings(config: DINOv2Config, params: Dict[str, torch.Tensor],
               pixel_values, dtype: torch.dtype):
    """Patch GEMM + CLS token + interpolated positions, in `dtype`.
    pixel_values: (B, H, W, C) normalised pixels."""
    p = config.patch_size
    batch, height, width, cin = pixel_values.shape
    gh, gw = height // p, width // p
    x = pixel_values.to(dtype).reshape(batch, gh, p, gw, p, cin)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(batch, gh * gw, p * p * cin)
    kernel = params["embeddings/patch_embeddings/projection/kernel"]
    kernel = kernel.to(dtype).reshape(p * p * cin, -1)
    bias = params["embeddings/patch_embeddings/projection/bias"].to(dtype)
    # bf16 operands, fp32 sum, one rounding: the flax bf16 Dense
    x = (x.float() @ kernel.float()).to(dtype) + bias
    cls = params["embeddings/cls_token"].to(dtype).expand(batch, 1, -1)
    x = torch.cat([cls, x], dim=1)
    pos = interpolate_pos_encoding(
        config, params["embeddings/position_embeddings"], height, width
    )
    return x + pos.to(dtype)


# ------------------------------ layer loop -------------------------------


#: the smallest tensor whose GELU forward takes the fused kernel when
#: HYPERVLA_FUSED_GELU=1 (the JAX package's own threshold)
FUSED_GELU_MIN_SIZE = 4 * 257 * 3072


class GeluExact(torch.autograd.Function):
    """Exact GELU of a bf16 tensor, evaluated in fp32 and rounded once; the
    backward keeps the bf16 input and computes the derivative in fp32
    (hypervla_tpu/models/encoders/dinov2.py::_gelu_exact). With
    HYPERVLA_FUSED_GELU=1 in the environment (read at each call) a tensor of
    at least FUSED_GELU_MIN_SIZE elements takes the fused forward kernel
    (ops/gelu.py); the backward is the same either way."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        if (os.environ.get("HYPERVLA_FUSED_GELU", "0") == "1"
                and x.numel() >= FUSED_GELU_MIN_SIZE):
            return gelu_exact_fused(x)
        return layers.gelu_exact(x.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        xf = x.float()
        cdf = 0.5 * torch.erfc(-xf * math.sqrt(0.5))
        pdf = torch.exp(-0.5 * xf * xf) * (1.0 / math.sqrt(2 * math.pi))
        return (cdf + xf * pdf).to(g.dtype) * g


def layer_norm_fn(fused_ln, plain: bool = False):
    """The LayerNorm `fused_ln` selects, as hypervla_tpu/models/encoders/
    dinov2.py::_layer_norm does: (x, scale, bias, eps) -> the normalised x
    (the caller rounds to its compute dtype). False: flax nn.LayerNorm;
    "dot": the same arithmetic (the JAX package's MXU ones-dot statistics
    are a way to schedule the sums, not another function); "pallas_train":
    the training LayerNorm kernel (ops/layer_norm.py); True: the one-pass,
    forward-only serving kernel beside it (two-pass variance), or with
    `plain` that kernel's plain version whatever the device."""
    if fused_ln == "pallas_train":
        return layer_norm_pallas
    if fused_ln is True:
        return layer_norm_reference if plain else layer_norm_one_pass
    if fused_ln in (False, None, "dot"):
        return layers.layer_norm
    raise ValueError(f"unknown fused_layer_norm {fused_ln!r}")


#: the aten matrix products each dino_remat_policy saves (the JAX
#: checkpoint_dots / checkpoint_dots_with_no_batch_dims / nothing_saveable)
REMAT_SAVED = {
    "dots": ("mm", "addmm", "bmm"),
    "dots_no_batch": ("mm", "addmm"),
    "nothing": (),
}


def remat_context(policy: Optional[str]):
    """The context_fn of torch.utils.checkpoint for a named policy: the
    saved matrix products kept, the rest recomputed in the backward (None:
    plain checkpoint, only the layer input saved). An unknown name raises
    KeyError, as the JAX dict does."""
    names = REMAT_SAVED[policy] if policy is not None else ()
    if not names:
        return torch.utils.checkpoint.noop_context_fn
    from torch.utils.checkpoint import (
        CheckpointPolicy,
        create_selective_checkpoint_contexts,
    )

    aten = torch.ops.aten
    saved = {getattr(aten, name).default for name in names}

    def policy_fn(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy_fn)


def _layer(config, params, prefix, x, dtype, fused_attention, layer_norm,
           flash=None, fused_add_ln=False, pending=None, capture=False):
    """One layer as flax's `_Layer` runs it in `dtype`: Dense layers as
    native-`dtype` matmuls with the cast bias added after, LayerNorm with
    fp32 statistics and one rounding, LayerScale cast to `dtype` before the
    multiply. Differentiable with torch autograd (not with `flash`, the
    forward-only attention function to use, if any).

    With fused_add_ln the layer takes the delayed-residual form: its two
    residual boundaries go through ops/add_layer_norm.py, it takes the
    previous layer's un-added residual as `pending` (delta, ls), or None in
    the first layer, and returns (x, (delta, ls)) with its own last residual
    un-added, for the next layer's norm1 (or the caller) to add.

    capture returns (x, the attention probabilities (B, heads, S, S) in
    `dtype`), on the einsum route (the caller turns the fused routes off,
    as the JAX trunk does for output_attentions)."""
    c = config
    heads = c.num_attention_heads
    head_dim = c.hidden_size // heads

    def lin(name, h):
        return (h @ params[f"{prefix}/{name}/kernel"].to(dtype)
                + params[f"{prefix}/{name}/bias"].to(dtype))

    def ln(name, h):
        return layer_norm(h, params[f"{prefix}/{name}/scale"],
                          params[f"{prefix}/{name}/bias"],
                          c.layer_norm_eps).to(dtype)

    def ls_vector(name):
        return c.layerscale_value * params[f"{prefix}/{name}/lambda1"].float()

    def add_ln(name, h, delta, ls):
        h, y = fused_add_scale_ln(
            h, delta.to(h.dtype), ls, params[f"{prefix}/{name}/scale"],
            params[f"{prefix}/{name}/bias"], c.layer_norm_eps)
        return h, y.to(dtype)

    def attention(n):
        att = "attention/attention"
        q, k, v = (lin(f"{att}/{name}", n)
                   for name in ("query", "key", "value"))
        if fused_attention:
            return fused_attention_op.mha_fused_train(
                q.bfloat16(), k.bfloat16(), v.bfloat16(), heads,
                1.0 / math.sqrt(head_dim)).to(dtype)
        shape = (*n.shape[:2], heads, head_dim)
        if flash:  # q is not pre-scaled: the kernel scales it in fp32
            return flash(q.reshape(shape), k.reshape(shape),
                         v.reshape(shape)).reshape(n.shape)
        q = q.reshape(shape) / torch.tensor(math.sqrt(head_dim), dtype=dtype)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k.reshape(shape))
        probs = torch.softmax(scores.float(), dim=-1).to(dtype)
        if capture:
            captured.append(probs)
        a = torch.einsum("bhqk,bkhd->bqhd", probs, v.reshape(shape))
        return a.reshape(n.shape)

    def mlp(y):
        h = lin("mlp/fc1", y)
        h = (layers.gelu_exact(h) if dtype == torch.float32
             else GeluExact.apply(h))
        return lin("mlp/fc2", h)

    captured = []
    if fused_add_ln:
        if pending is None:
            n = ln("norm1", x)
        else:
            x, n = add_ln("norm1", x, *pending)
        x, y = add_ln("norm2", x, lin("attention/output/dense", attention(n)),
                      ls_vector("layer_scale1"))
        return x, (mlp(y), ls_vector("layer_scale2"))
    a = attention(ln("norm1", x))
    x = ls_vector("layer_scale1").to(dtype) * lin("attention/output/dense",
                                                  a) + x
    x = ls_vector("layer_scale2").to(dtype) * mlp(ln("norm2", x)) + x
    return (x, captured[0]) if capture else x


def dinov2_forward(config: DINOv2Config, params: Dict[str, torch.Tensor],
                   pixel_values, dtype: torch.dtype = torch.float32,
                   fused_attention: bool = False, layer_kernel: bool = False,
                   fused_ln=False, use_flash: bool = False,
                   fused_add_ln: bool = False, plain: bool = False,
                   remat=False, attentions: Optional[list] = None):
    """DINOv2 -> last_hidden_state (B, 1 + patches, hidden), fp32.

    dtype is the compute dtype (the params stay fp32). fused_attention runs
    attention through ops/fused_attention.py (bf16, differentiable).
    layer_kernel runs every layer through ops/dino_layer_train.py (bf16):
    on params packed by `pack_frozen_layers`, its no-residual forward
    without autograd (the frozen encoder's route); on per-layer fp32 leaves,
    the differentiable layer (the counterpart of the JAX package's
    `_KernelLayerCollection`: the operands are stacked and cast per call, so
    autograd carries their gradients back to the leaves). fused_ln chooses
    the LayerNorms left outside the layer kernel (`layer_norm_fn`).
    use_flash runs attention through ops/flash_attention.py (forward only;
    the fused training attention wins where both are set). fused_add_ln
    runs the layers in the delayed-residual form of `_layer` (the layer
    kernel wins where both are set); the last layer's residual is added
    here, plainly, with the per-op roundings of LayerScale and add. plain
    puts the plain versions of the two forward-only serving kernels (flash
    attention, the one-pass LayerNorm) in their place whatever the device,
    for a caller that holds the kernels against them.

    remat (True, or a name of REMAT_SAVED) checkpoints each layer of the
    layer loop: True and "nothing" keep only the layer inputs, "dots" and
    "dots_no_batch" the matrix products of `remat_context`; the layer
    kernel (which keeps its own) and the delayed-residual form (which the
    JAX package refuses under remat) take no remat. attentions, a list,
    receives each layer's attention probabilities (B, heads, S, S) in the
    compute dtype; the layers then run the einsum attention."""
    layer_norm = layer_norm_fn(fused_ln, plain)
    flash = None
    if use_flash:
        flash = mha_flash_reference if plain else mha_flash
    if layer_kernel and dtype != torch.bfloat16:
        raise ValueError("the layer kernel is bf16: set encoder_dtype="
                         "'bfloat16'")
    x = embeddings(config, params, pixel_values, dtype)
    pending = None
    for i in range(config.num_hidden_layers):
        prefix = f"encoder/layer/{i}"
        if layer_kernel and f"{prefix}/packed/wqkv" in params:
            x = dino_layer_train.dino_layer_train_packed(
                x, tuple(params[f"{prefix}/packed/{name}"]
                         for name in dino_layer_train.OPERANDS),
                config.num_attention_heads, config.layer_norm_eps)
        elif layer_kernel:
            x = dino_layer_train.dino_layer_train(
                x, *dino_layer_train.layer_operands(
                    params, prefix, config.layerscale_value),
                config.num_attention_heads, config.layer_norm_eps)
        elif fused_add_ln and attentions is None:
            x, pending = _layer(config, params, prefix, x, dtype,
                                fused_attention, layer_norm, flash, True,
                                pending)
        else:
            capture = attentions is not None
            run = functools.partial(
                _layer, config, params, prefix, dtype=dtype,
                fused_attention=fused_attention and not capture,
                layer_norm=layer_norm, flash=None if capture else flash,
                capture=capture)
            if remat:
                context_fn = remat_context(
                    None if remat is True else remat)
                x = torch.utils.checkpoint.checkpoint(
                    run, x, use_reentrant=False, context_fn=context_fn)
            else:
                x = run(x)
            if capture:
                x, probs = x
                attentions.append(probs)
    if pending is not None:
        delta, ls = pending
        x = (x + ls.to(x.dtype) * delta).to(x.dtype)
    x = layer_norm(x, params["layernorm/scale"], params["layernorm/bias"],
                   config.layer_norm_eps)
    return x.to(dtype).float()


def pack_frozen_layers(config: DINOv2Config,
                       params: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """The frozen encoder's params for dinov2_forward(layer_kernel=True):
    each layer's leaves replaced, once, by the layer forward's operands
    (ops/dino_layer_train.py::pack_layer_params: bf16 weights, QKV
    concatenated) keyed "encoder/layer/<i>/packed/<operand>"."""
    out = {k: v for k, v in params.items()
           if not k.startswith("encoder/layer/")}
    for i in range(config.num_hidden_layers):
        prefix = f"encoder/layer/{i}"
        ops = dino_layer_train.pack_layer_params(params, prefix,
                                                 config.layerscale_value)
        out.update({f"{prefix}/packed/{name}": t
                    for name, t in zip(dino_layer_train.OPERANDS, ops)})
    return out


def dinov2_serving_forward(config: DINOv2Config,
                           params: Dict[str, torch.Tensor], pixel_values,
                           trunk_impl: str = "kernel"):
    """bf16 serving forward over prepared params (ops/serving.py): bf16
    embeddings, the stacked trunk one frame at a time (one launch a frame),
    bf16 final LayerNorm. trunk_impl "kernel" runs ops/dino_layer.py::
    dino_layers_serving (the CUDA kernels for a CUDA tensor), "reference"
    its plain version."""
    trunk = {
        "kernel": dino_layer.dino_layers_serving,
        "reference": dino_layer.dino_layers_serving_reference,
    }[trunk_impl]
    x = embeddings(config, params, pixel_values, torch.bfloat16)
    x = torch.stack([trunk(frame, params["trunk/w"], params["trunk/b"],
                           params["trunk/p"], config.layer_norm_eps)
                     for frame in x])
    x = layers.layer_norm(x, params["layernorm/scale"],
                          params["layernorm/bias"], config.layer_norm_eps)
    return x.bfloat16().float()


def dinov2_specs(config: DINOv2Config, prefix: str
                 ) -> Dict[str, Tuple[tuple, layers.Init]]:
    """Param shapes and initializers (the JAX package's HF-style init:
    variance_scaling(range^2, fan_in, truncated normal) for kernels and
    tokens, zero biases, unit norms and layer scales)."""
    c = config
    d = c.hidden_size
    hf = layers.variance_scaling(c.initializer_range ** 2)
    grid = c.image_size // c.patch_size
    e = f"{prefix}/embeddings"
    specs = {
        f"{e}/cls_token": ((1, 1, d), hf),
        f"{e}/patch_embeddings/projection/bias": ((d,), layers.zeros),
        f"{e}/patch_embeddings/projection/kernel": (
            (c.patch_size, c.patch_size, c.num_channels, d), hf),
        f"{e}/position_embeddings": ((1, grid * grid + 1, d), hf),
        f"{prefix}/layernorm/bias": ((d,), layers.zeros),
        f"{prefix}/layernorm/scale": ((d,), layers.ones),
    }
    if c.use_mask_token:
        specs[f"{e}/mask_token"] = ((1, d), hf)
    for i in range(c.num_hidden_layers):
        lp = f"{prefix}/encoder/layer/{i}"
        dense = {"attention/attention/query": (d, d),
                 "attention/attention/key": (d, d),
                 "attention/attention/value": (d, d),
                 "attention/output/dense": (d, d),
                 "mlp/fc1": (d, c.mlp_ratio * d),
                 "mlp/fc2": (c.mlp_ratio * d, d)}
        for name, shape in dense.items():
            specs[f"{lp}/{name}/kernel"] = (shape, hf)
            specs[f"{lp}/{name}/bias"] = ((shape[1],), layers.zeros)
        for name in ("layer_scale1/lambda1", "layer_scale2/lambda1",
                     "norm1/scale", "norm2/scale"):
            specs[f"{lp}/{name}"] = ((d,), layers.ones)
        for name in ("norm1/bias", "norm2/bias"):
            specs[f"{lp}/{name}"] = ((d,), layers.zeros)
    return specs
