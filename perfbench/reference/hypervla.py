"""Plain fp32 PyTorch reference of a HyperVLA training step and of its
served forward, written from the model's description (HyperVLA, arXiv
2510.04898, and the layer equations of its JAX configuration): no kernel,
no batching trick, no import of the program under test.

The model, for one sample:
  * the frozen T5 encoder embeds the instruction (RMS norm, relative
    position bias of block 0, ReLU feed-forward, no 1/sqrt(d) scale);
  * with initial-image conditioning the frozen DINOv2 encodes the first
    frame, and its class token (after the final LayerNorm) joins the
    context;
  * the context encoder (pre-LN transformer, tanh GELU) runs over
    [instruction tokens | initial-image token | layer token]; the layer
    token's output, scaled by 1/sqrt(width) where the config says so, is
    the task's context vector c;
  * every generated base-net block is c @ K + b of its own output head
    ("block") or a slice of one head over all blocks ("full"); shared
    blocks (the DINOv2 trunk) are trainable params used as they are;
  * the policy ViT: the frame through the shared DINOv2 trunk (class
    token dropped) or the generated weight-standardised conv stem, a
    projection to the policy width, a readout token, learned positions,
    pre-LN blocks whose rows may not look at the readout, the readout's
    final embedding;
  * the head: the mix head (tanh-squashed arm dims, a gripper logit) or
    the continuous head; the loss is the per-sample masked MSE (times the
    dims) plus the gripper's binary cross-entropy, averaged over the batch.
The optimizer is the configuration's: global-norm clipping, AdamW with a
bf16-stored first moment (decayed by b1 rounded to bf16, as optax does
with mu_dtype bfloat16), the rsqrt schedule after warm-up, one group for
the shared trunk and one for the rest, weight decay on the output heads
that generate kernels, and the EMA of the params.

`lower=True` computes the same in the nearest precision below the one the
configuration states, the control of the benchmark's comparison: the parts
that run in bfloat16 (the trunk, the frozen DINOv2) with every operand of
their matrix products, forward and backward, rounded to float8 e4m3 (a
per-tensor scale), the float32 parts on TF32-rounded operands.
"""
import contextlib
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

Params = Dict[str, torch.Tensor]


# ------------------------------ numerics ---------------------------------


def fp8(x):
    """x rounded to float8 e4m3 on a per-tensor scale (its largest
    magnitude at the format's largest, 448)."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest even)."""
    bits = x.contiguous().view(torch.int32)
    bits = bits + 0xFFF + ((bits >> 13) & 1)
    return (bits & -8192).view(torch.float32)


class _Fp8MatMul(torch.autograd.Function):
    """a @ b with every operand of the forward and the backward products
    in float8 e4m3, accumulated in fp32."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return fp8(a) @ fp8(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g8, a8, b8 = fp8(g), fp8(a), fp8(b)
        ga = g8 @ b8.transpose(-1, -2)
        if b.dim() == 2:
            gb = a8.reshape(-1, a.shape[-1]).t() @ g8.reshape(-1, g.shape[-1])
        else:
            gb = a8.transpose(-1, -2) @ g8
        return ga, gb


class _TF32Mode(TorchDispatchMode):
    """Every matrix product and convolution, forward and backward, on
    TF32-rounded operands (fp32 accumulation): TF32's arithmetic."""

    OPERANDS = {
        torch.ops.aten.mm.default: (0, 1),
        torch.ops.aten.addmm.default: (1, 2),
        torch.ops.aten.bmm.default: (0, 1),
        torch.ops.aten.baddbmm.default: (1, 2),
        torch.ops.aten.convolution.default: (0, 1),
        torch.ops.aten.convolution_backward.default: (0, 1, 2),
    }

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        which = self.OPERANDS.get(func)
        if which:
            args = list(args)
            for i in which:
                if isinstance(args[i], torch.Tensor) and \
                        args[i].dtype == torch.float32:
                    args[i] = tf32(args[i])
        return func(*args, **(kwargs or {}))


class Numerics:
    """The reference's precision: plain fp32, or with `lower` its control:
    the parts the configuration runs in bfloat16 (`mm(..., trunk=True)`:
    the trunk and the frozen DINOv2) in float8, all else (inside `scope`)
    in TF32."""

    def __init__(self, lower: bool):
        self.lower = lower

    def mm(self, a, b, trunk: bool = False):
        if self.lower and trunk:
            return _Fp8MatMul.apply(a, b)
        return a @ b

    def scope(self):
        return _TF32Mode() if self.lower else contextlib.nullcontext()


def layer_norm(x, scale=None, bias=None, eps: float = 1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    y = (x - mu) / torch.sqrt(var + eps)
    if scale is not None:
        y = y * scale
    if bias is not None:
        y = y + bias
    return y


def masked_attention(q, k, v, mask, scale):
    """q, k, v (..., len, heads, d); mask (..., 1 or heads, q, k) bool."""
    s = torch.einsum("...qhd,...khd->...hqk", q, k) * scale
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("...hqk,...khd->...qhd", p, v)


# --------------------------------- T5 ------------------------------------


def t5_buckets(length: int, num_buckets: int, max_distance: int, device):
    pos = torch.arange(length, device=device)
    n = -(pos[None, :] - pos[:, None])
    half = num_buckets // 2
    ret = (n < 0).long() * half
    n = n.abs()
    exact = half // 2
    large = exact + (torch.log(n.float() / exact + 1e-6)
                     / math.log(max_distance / exact)
                     * (half - exact)).long()
    large = torch.clamp(large, max=half - 1)
    return ret + torch.where(n < exact, n, large)


def t5_encode(t5: dict, P: Params, ids, mask):
    """(B, L) ids and attention mask -> (B, L, d_model)."""
    h, dk = t5["num_heads"], t5["d_kv"]
    eps = t5["layer_norm_epsilon"]

    def rms(x, w):
        return w * x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps)

    x = P["shared_embedding"][ids.long()]
    b, length = ids.shape
    bucket = t5_buckets(length, t5["relative_attention_num_buckets"],
                        t5["relative_attention_max_distance"], ids.device)
    bias = P["block_0/layer_0_SelfAttention/relative_attention_bias"][bucket]
    bias = bias.permute(2, 0, 1)[None]
    keep = mask.bool()[:, None, None, :]
    for i in range(t5["num_layers"]):
        blk = f"block_{i}"
        att = f"{blk}/layer_0_SelfAttention"
        n = rms(x, P[f"{blk}/layer_0_layer_norm/weight"])
        q, k, v = ((n @ P[f"{att}/{w}/kernel"]).reshape(b, length, h, dk)
                   for w in "qkv")
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) + bias
        s = s.masked_fill(~keep, float("-inf"))
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
        x = x + o.reshape(b, length, h * dk) @ P[f"{att}/o/kernel"]
        n = rms(x, P[f"{blk}/layer_1_layer_norm/weight"])
        y = torch.relu(n @ P[f"{blk}/layer_1_DenseReluDense_wi/kernel"])
        x = x + y @ P[f"{blk}/layer_1_DenseReluDense_wo/kernel"]
    return rms(x, P["final_layer_norm/weight"])


def t5_shapes(t5: dict) -> Dict[str, tuple]:
    d, inner, ff = t5["d_model"], t5["num_heads"] * t5["d_kv"], t5["d_ff"]
    shapes = {"shared_embedding": (t5["vocab_size"], d)}
    for i in range(t5["num_layers"]):
        blk = f"block_{i}"
        att = f"{blk}/layer_0_SelfAttention"
        shapes.update({f"{blk}/layer_0_layer_norm/weight": (d,),
                       f"{att}/q/kernel": (d, inner),
                       f"{att}/k/kernel": (d, inner),
                       f"{att}/v/kernel": (d, inner),
                       f"{att}/o/kernel": (inner, d),
                       f"{blk}/layer_1_layer_norm/weight": (d,),
                       f"{blk}/layer_1_DenseReluDense_wi/kernel": (d, ff),
                       f"{blk}/layer_1_DenseReluDense_wo/kernel": (ff, d)})
        if i == 0:
            shapes[f"{att}/relative_attention_bias"] = (
                t5["relative_attention_num_buckets"], t5["num_heads"])
    shapes["final_layer_norm/weight"] = (d,)
    return shapes


# -------------------------------- DINOv2 ---------------------------------


def _cubic(x):
    """Keys' cubic kernel, a = -0.5."""
    x = x.abs()
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return torch.where(x < 1.0, near, torch.where(x < 2.0, far,
                                                  torch.zeros_like(x)))


def _lanczos3(x):
    x = x.abs()
    safe = torch.where(x < 1e-3, torch.ones_like(x), x)
    y = 3.0 * torch.sin(math.pi * safe) * torch.sin(math.pi * safe / 3.0) / (
        math.pi ** 2 * safe ** 2)
    y = torch.where(x < 1e-3, torch.ones_like(x), y)
    return torch.where(x < 3.0, y, torch.zeros_like(x))


def _triangle(x):
    return torch.clamp(1.0 - x.abs(), min=0.0)


def scale_translate_matrix(n_in: int, n_out: int, scale: float,
                           translation: float, kernel, antialias: bool,
                           device):
    """(n_in, n_out) weights of a scale-and-translate resampling along one
    axis: output sample j reads input position (j + 0.5 - translation) /
    scale - 0.5 (half-pixel centres), the kernel widened by 1/scale where
    antialiasing a downsample, columns normalised to sum 1, samples that
    fall outside the input zeroed."""
    inv = 1.0 / scale
    width = max(inv, 1.0) if antialias else 1.0
    sample = ((torch.arange(n_out, dtype=torch.float64, device=device) + 0.5)
              * inv - translation * inv - 0.5)
    src = torch.arange(n_in, dtype=torch.float64, device=device)
    w = kernel((sample[None, :] - src[:, None]) / width)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1e-9, w / torch.where(
        total == 0, torch.ones_like(total), total), torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).float()


def _resample(x, wy, wx):
    x = torch.einsum("nhwc,ha->nawc", x, wy)
    return torch.einsum("nawc,wb->nabc", x, wx)


def _to_uint8(x):
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def resize(images, side: int):
    """uint8 (N, H, W, 3) -> uint8 (N, side, side, 3): Lanczos3 with
    antialiasing, rounded."""
    n, h, w, _ = images.shape
    if (h, w) == (side, side):
        return images
    dev = images.device
    wy = scale_translate_matrix(h, side, side / h, 0.0, _lanczos3, True, dev)
    wx = scale_translate_matrix(w, side, side / w, 0.0, _lanczos3, True, dev)
    return _to_uint8(_resample(images.float(), wy, wx))


def center_crop(images, side: int, area: float = 0.9):
    """The centred crop of `area` of the frame, bilinearly resampled back
    to side x side (no antialiasing), rounded."""
    n, h, w, _ = images.shape
    crop = math.sqrt(area)
    lo = (1.0 - crop) / 2
    dev = images.device

    def axis(n_in):
        scale = crop * (n_in - 1) / (side - 1)
        return scale_translate_matrix(n_in, side, 1.0 / scale,
                                      -lo * (n_in - 1) / scale, _triangle,
                                      False, dev)

    return _to_uint8(_resample(images.float(), axis(h), axis(w)))


def dino_positions(dino: dict, table, height: int, width: int):
    """The trained position grid resampled onto this frame's patch grid
    (bicubic, the target extent grown by 0.1 patch)."""
    n_pos = table.shape[1] - 1
    gh, gw = height // dino["patch_size"], width // dino["patch_size"]
    if gh * gw == n_pos and height == width:
        return table
    src = int(math.isqrt(n_pos))
    grid = table[0, 1:].reshape(src, src, -1)
    wy = scale_translate_matrix(src, gh, (gh + 0.1) / src, 0.0, _cubic,
                                False, table.device)
    wx = scale_translate_matrix(src, gw, (gw + 0.1) / src, 0.0, _cubic,
                                False, table.device)
    out = torch.einsum("ijd,ia,jb->abd", grid, wy, wx).reshape(1, gh * gw, -1)
    return torch.cat([table[:, :1], out], dim=1)


DINO_MEAN = (0.485, 0.456, 0.406)
DINO_STD = (0.229, 0.224, 0.225)


def dino_encode(dino: dict, P: Params, prefix: str, images, num: Numerics):
    """uint8 (B, H, W, 3) -> last hidden state after the final LayerNorm
    (B, 1 + patches, width). Params under `prefix` (shape as published)."""
    def p(name):
        return P[f"{prefix}{name}"]

    mean = torch.tensor(DINO_MEAN, device=images.device)
    std = torch.tensor(DINO_STD, device=images.device)
    x = (images.float() / 255.0 - mean) / std
    b, height, width, c = x.shape
    ps = dino["patch_size"]
    gh, gw = height // ps, width // ps
    patches = x.reshape(b, gh, ps, gw, ps, c).permute(0, 1, 3, 2, 4, 5)
    patches = patches.reshape(b, gh * gw, ps * ps * c)
    kernel = p("embeddings/patch_embeddings/projection/kernel")
    x = num.mm(patches, kernel.reshape(ps * ps * c, -1), trunk=True)
    x = x + p("embeddings/patch_embeddings/projection/bias")
    x = torch.cat([p("embeddings/cls_token").expand(b, 1, -1), x], dim=1)
    x = x + dino_positions(dino, p("embeddings/position_embeddings"),
                           height, width)
    heads = dino["num_attention_heads"]
    d = x.shape[-1]
    eps = dino["layer_norm_eps"]
    ls = dino["layerscale_value"]

    def lin(name, h):
        return (num.mm(h, p(f"{name}/kernel"), trunk=True)
                + p(f"{name}/bias"))

    for i in range(dino["num_hidden_layers"]):
        lp = f"encoder/layer/{i}/"
        n = layer_norm(x, p(lp + "norm1/scale"), p(lp + "norm1/bias"), eps)
        q, k, v = (lin(lp + f"attention/attention/{w}", n).reshape(
            b, -1, heads, d // heads).transpose(1, 2)
            for w in ("query", "key", "value"))
        scores = num.mm(q, k.transpose(-1, -2), trunk=True)
        probs = torch.softmax(scores / math.sqrt(d // heads), dim=-1)
        a = num.mm(probs, v, trunk=True).transpose(1, 2)
        a = lin(lp + "attention/output/dense", a.reshape(b, -1, d))
        x = x + ls * p(lp + "layer_scale1/lambda1") * a
        n = layer_norm(x, p(lp + "norm2/scale"), p(lp + "norm2/bias"), eps)
        hid = lin(lp + "mlp/fc1", n)
        hid = 0.5 * hid * (1.0 + torch.erf(hid / math.sqrt(2.0)))
        x = x + ls * p(lp + "layer_scale2/lambda1") * lin(lp + "mlp/fc2", hid)
    return layer_norm(x, p("layernorm/scale"), p("layernorm/bias"), eps)


def dino_shapes(dino: dict, prefix: str) -> Dict[str, tuple]:
    d = dino["hidden_size"]
    ps, grid = dino["patch_size"], dino["image_size"] // dino["patch_size"]
    shapes = {
        "embeddings/cls_token": (1, 1, d),
        "embeddings/mask_token": (1, d),
        "embeddings/patch_embeddings/projection/bias": (d,),
        "embeddings/patch_embeddings/projection/kernel": (ps, ps, 3, d),
        "embeddings/position_embeddings": (1, grid * grid + 1, d),
        "layernorm/bias": (d,),
        "layernorm/scale": (d,),
    }
    m = dino["mlp_ratio"] * d
    for i in range(dino["num_hidden_layers"]):
        lp = f"encoder/layer/{i}/"
        for name, shape in (("attention/attention/query", (d, d)),
                            ("attention/attention/key", (d, d)),
                            ("attention/attention/value", (d, d)),
                            ("attention/output/dense", (d, d)),
                            ("mlp/fc1", (d, m)), ("mlp/fc2", (m, d))):
            shapes[f"{lp}{name}/kernel"] = shape
            shapes[f"{lp}{name}/bias"] = (shape[1],)
        for name in ("layer_scale1/lambda1", "layer_scale2/lambda1",
                     "norm1/scale", "norm1/bias", "norm2/scale",
                     "norm2/bias"):
            shapes[lp + name] = (d,)
    return {prefix + k: v for k, v in shapes.items()}


# ------------------------------ transformer ------------------------------


def transformer_shapes(prefix: str, d: int, layers: int, mlp: int,
                       heads: int) -> Dict[str, tuple]:
    shapes = {}
    for i in range(layers):
        blk = f"{prefix}/encoderblock_{i}"
        for ln in ("LayerNorm_0", "LayerNorm_1"):
            shapes[f"{blk}/{ln}/bias"] = (d,)
            shapes[f"{blk}/{ln}/scale"] = (d,)
        shapes[f"{blk}/MlpBlock_0/Dense_0/kernel"] = (d, mlp)
        shapes[f"{blk}/MlpBlock_0/Dense_0/bias"] = (mlp,)
        shapes[f"{blk}/MlpBlock_0/Dense_1/kernel"] = (mlp, d)
        shapes[f"{blk}/MlpBlock_0/Dense_1/bias"] = (d,)
        att = f"{blk}/MultiHeadAttention_0"
        for w in ("query", "key", "value"):
            shapes[f"{att}/{w}/kernel"] = (d, heads, d // heads)
            shapes[f"{att}/{w}/bias"] = (heads, d // heads)
        shapes[f"{att}/out/kernel"] = (heads, d // heads, d)
        shapes[f"{att}/out/bias"] = (d,)
    shapes[f"{prefix}/encoder_norm/bias"] = (d,)
    shapes[f"{prefix}/encoder_norm/scale"] = (d,)
    return shapes


def transformer(P: Params, prefix: str, x, mask, layers: int, heads: int):
    """Pre-LN blocks and a final LayerNorm. Weights may carry a leading
    sample axis (kernels (B, in, ...), vectors (B, ...)); x is (B, L, d)."""
    b, length, d = x.shape
    for i in range(layers):
        blk = f"{prefix}/encoderblock_{i}"
        y = _ln(P, f"{blk}/LayerNorm_0", x, b)
        att = f"{blk}/MultiHeadAttention_0"
        q, k, v = (_dense(P, f"{att}/{w}", y, b).reshape(
            b, length, heads, d // heads) for w in ("query", "key", "value"))
        a = masked_attention(q, k, v, mask, 1.0 / math.sqrt(d // heads))
        x = x + _dense(P, f"{att}/out", a.reshape(b, length, d), b)
        y = _ln(P, f"{blk}/LayerNorm_1", x, b)
        hid = F.gelu(_dense(P, f"{blk}/MlpBlock_0/Dense_0", y, b),
                     approximate="tanh")
        x = x + _dense(P, f"{blk}/MlpBlock_0/Dense_1", hid, b)
    return _ln(P, f"{prefix}/encoder_norm", x, b)


class Weights(dict):
    """Base-net params; `per_sample` names the generated ones, which carry
    a leading sample axis."""

    per_sample = frozenset()


def _ln(P, prefix, x, b):
    scale, bias = P[f"{prefix}/scale"], P[f"{prefix}/bias"]
    if f"{prefix}/scale" in P.per_sample if isinstance(P, Weights) else False:
        scale, bias = scale.reshape(b, 1, -1), bias.reshape(b, 1, -1)
    return layer_norm(x, scale, bias)


def _dense(P, prefix, x, b):
    """x (B, L, in) @ kernel -> (B, L, out); the kernel is shared (in,
    ...) or per sample (B, in, ...) as its leading axis and rank say."""
    w, bias = P[f"{prefix}/kernel"], P[f"{prefix}/bias"]
    fan_in = x.shape[-1]
    if isinstance(P, Weights) and f"{prefix}/kernel" in P.per_sample:
        y = torch.bmm(x, w.reshape(b, fan_in, -1))
        return y + bias.reshape(b, 1, -1)
    return x @ w.reshape(fan_in, -1) + bias.reshape(-1)


# ----------------------------- the base net ------------------------------


def base_net_shapes(cfg: dict) -> Dict[str, tuple]:
    """Every base-net block of the configuration, by its path."""
    bk = cfg["config"]["base_net_kwargs"]
    vk = bk["vit_kwargs"]
    hd = vk["hidden_dim"]
    shapes = {}
    enc = vk["encoder_type"]
    if enc == "DINOv2":
        dino = cfg["dinov2"]
        n_patch = (224 // dino["patch_size"]) ** 2
        shapes["encoder/image_embedding_projection/kernel"] = (
            dino["hidden_size"], hd)
        shapes["encoder/image_embedding_projection/bias"] = (hd,)
        shapes.update(dino_shapes(dino, "encoder/image_encoder/"))
    elif enc == "SmallStem":
        c_in, side = 3, 224
        for i, f in enumerate(vk["cnn_channels"]):
            shapes[f"encoder/SmallStem_0/StdConv_{i}/kernel"] = (3, 3, c_in, f)
            shapes[f"encoder/SmallStem_0/StdConv_{i}/bias"] = (f,)
            shapes[f"encoder/SmallStem_0/GroupNorm_{i}/scale"] = (f,)
            shapes[f"encoder/SmallStem_0/GroupNorm_{i}/bias"] = (f,)
            c_in, side = f, (side + 2 - 3) // 2 + 1
        patch = vk["patch_size"] // 16
        shapes["encoder/SmallStem_0/embedding/kernel"] = (patch, patch, c_in,
                                                          hd)
        shapes["encoder/SmallStem_0/embedding/bias"] = (hd,)
        n_patch = (side // patch) ** 2
    else:
        raise NotImplementedError(enc)
    shapes["encoder/pos_embedding"] = (1, n_patch + 1, hd)
    shapes.update(transformer_shapes("encoder/Transformer_0", hd,
                                     vk["num_layers"], vk["mlp_dim"],
                                     vk["num_heads"]))
    horizon, adim = bk["action_horizon"], bk["action_dim"]
    head = bk["action_head_type"]
    if head == "mix":
        shapes["action_head/continuous_head/kernel"] = (hd, horizon * (adim - 1))
        shapes["action_head/continuous_head/bias"] = (horizon * (adim - 1),)
        shapes["action_head/discrete_head/kernel"] = (hd, horizon)
        shapes["action_head/discrete_head/bias"] = (horizon,)
    elif head == "continuous":
        shapes["action_head/mean_proj/kernel"] = (hd, horizon * adim)
        shapes["action_head/mean_proj/bias"] = (horizon * adim,)
    else:
        raise NotImplementedError(head)
    return shapes


def flat_name(path: str) -> str:
    return path.replace("/", "_")


class HyperVLAReference:
    """The reference of one configuration file (perfbench/configs/*.json)."""

    def __init__(self, cfg: dict, lower: bool = False):
        self.cfg = cfg
        self.config = cfg["config"]
        self.num = Numerics(lower)
        self.blocks = base_net_shapes(cfg)
        hk = self.config["hypernet_kwargs"]
        self.strategy = hk["generation_strategy"]
        shared = tuple(hk.get("shared_modules", ()))
        self.generated = {n: not any(m in key for m in shared
                                     for key in n.split("/"))
                          for n in self.blocks}
        self.order = sorted(self.blocks, key=lambda n: tuple(n.split("/")))
        if self.strategy == "block" and not hk.get("share_layer_index"):
            raise NotImplementedError("block generation without "
                                      "share_layer_index")

    # -- the names and shapes of the trainable params --------------------

    def param_shapes(self, instr_len: int, token_dim: int
                     ) -> Dict[str, tuple]:
        hk = self.config["hypernet_kwargs"]
        c = hk["context_embedding_dim"]
        ce = hk["context_encoder_kwargs"]
        shapes = {"task_token_projection/kernel": (token_dim, c),
                  "task_token_projection/bias": (c,),
                  "task_pos_embedding": (1, instr_len, c),
                  "layer_pos_embedding": (1, 1, c)}
        if hk.get("use_initial_image"):
            width = self.cfg["dinov2"]["hidden_size"]
            shapes.update({"initial_image_projection/kernel": (width, c),
                           "initial_image_projection/bias": (c,),
                           "initial_image_pos_embedding": (1, 1, c)})
        shapes.update(transformer_shapes("context_encoder", c,
                                         ce["num_layers"], ce["mlp_dim"],
                                         ce["num_attention_heads"]))
        total = sum(math.prod(s) for s in self.blocks.values())
        if self.strategy == "full":
            shapes["output_head/kernel"] = (c, total)
            shapes["output_head/bias"] = (total,)
        for n in self.order:
            dim = math.prod(self.blocks[n])
            if not self.generated[n]:
                shapes[flat_name(n)] = (dim,)
            elif self.strategy == "block":
                shapes[f"output_head_{flat_name(n)}/kernel"] = (c, dim)
                shapes[f"output_head_{flat_name(n)}/bias"] = (dim,)
        return shapes

    # -- forward -----------------------------------------------------------

    def context(self, P: Params, tokens, token_mask, image_cls):
        """(B, L, token_dim) instruction embedding, its mask, the initial
        frame's class token (B, 1, width) or None -> c (B, width)."""
        hk = self.config["hypernet_kwargs"]
        ce = hk["context_encoder_kwargs"]
        b, length = tokens.shape[:2]
        parts = [tokens @ P["task_token_projection/kernel"]
                 + P["task_token_projection/bias"] + P["task_pos_embedding"]]
        if image_cls is not None:
            parts.append(image_cls @ P["initial_image_projection/kernel"]
                         + P["initial_image_projection/bias"]
                         + P["initial_image_pos_embedding"])
        c = hk["context_embedding_dim"]
        parts.append(P["layer_pos_embedding"].expand(b, 1, c))
        x = torch.cat(parts, dim=1)
        total = x.shape[1]
        cols = torch.ones(b, total, dtype=torch.bool, device=x.device)
        if not hk["attend_to_padding"]:
            cols[:, :length] = token_mask.bool()
        mask = cols[:, None, None, :].expand(b, 1, total, total).clone()
        if not hk["task_attend_to_layer"]:
            mask[:, :, :-1, -1] = False
        out = transformer(P, "context_encoder", x, mask, ce["num_layers"],
                          ce["num_attention_heads"])[:, -1]
        if hk.get("scale_context_embedding"):
            out = out / math.sqrt(c)
        return out

    def generate(self, P: Params, ctx) -> Params:
        """Base-net params (`Weights`): generated blocks per sample (B,
        *shape), shared blocks as they are."""
        b = ctx.shape[0]
        out = Weights()
        if self.strategy == "full":
            flat = ctx @ P["output_head/kernel"] + P["output_head/bias"]
            sizes = [math.prod(self.blocks[n]) for n in self.order]
            for n, part in zip(self.order, torch.split(flat, sizes, dim=1)):
                out[n] = part.reshape(b, *self.blocks[n])
        for n in self.order:
            if not self.generated[n]:
                out[n] = P[flat_name(n)].reshape(self.blocks[n])
            elif self.strategy == "block":
                head = f"output_head_{flat_name(n)}"
                out[n] = (ctx @ P[f"{head}/kernel"] + P[f"{head}/bias"]
                          ).reshape(b, *self.blocks[n])
        out.per_sample = frozenset(n for n in out if self.generated[n])
        return out

    def image_tokens(self, G: Params, images):
        """The policy's patch tokens (B, n, hidden) from uint8 frames."""
        vk = self.config["base_net_kwargs"]["vit_kwargs"]
        b = images.shape[0]
        if vk["encoder_type"] == "DINOv2":
            emb = dino_encode(self.cfg["dinov2"], G, "encoder/image_encoder/",
                              images, self.num)[:, 1:]
            return _dense(G, "encoder/image_embedding_projection", emb, b)
        x = images.float() / 127.5 - 1.0
        x = x.permute(0, 3, 1, 2)
        for i in range(len(vk["cnn_channels"])):
            pre = f"encoder/SmallStem_0/StdConv_{i}"
            w = G[f"{pre}/kernel"]  # (B, kh, kw, cin, cout)
            w = w - w.mean((1, 2, 3), keepdim=True)
            w = w / (w.var((1, 2, 3), unbiased=False, keepdim=True).sqrt()
                     + 1e-5)
            x = _grouped_conv(x, w, G[f"{pre}/bias"], stride=2, padding=1)
            gn = f"encoder/SmallStem_0/GroupNorm_{i}"
            x = torch.relu(_group_norm(x, G[f"{gn}/scale"], G[f"{gn}/bias"]))
        patch = vk["patch_size"] // 16
        x = _grouped_conv(x, G["encoder/SmallStem_0/embedding/kernel"],
                          G["encoder/SmallStem_0/embedding/bias"],
                          stride=patch, padding=0)
        return x.permute(0, 2, 3, 1).reshape(b, -1, x.shape[1])

    def policy(self, G: Params, images, actions=None):
        """Per-sample loss (B,) where actions are given, else the head's
        outputs: (arm (B, H, A - 1), gripper logits (B, H)) for the mix
        head, (actions (B, H, A),) for the continuous one."""
        bk = self.config["base_net_kwargs"]
        vk = bk["vit_kwargs"]
        patches = self.image_tokens(G, images)
        b, n, hd = patches.shape
        x = torch.cat([patches, patches.new_zeros(b, 1, hd)], dim=1)
        x = x + G["encoder/pos_embedding"].reshape(b, n + 1, hd)
        mask = torch.ones(n + 1, n + 1, dtype=torch.bool, device=x.device)
        mask[:n, n:] = False
        x = transformer(G, "encoder/Transformer_0", x, mask,
                        vk["num_layers"], vk["num_heads"])
        readout = x[:, -1:]
        kw = bk["action_head_kwargs"]
        horizon, adim = bk["action_horizon"], bk["action_dim"]

        def squash(v):
            if not kw.get("squash_continuous_action", True):
                return v
            return torch.tanh(v / kw["tanh_scaling_factor"]) * kw["max_action"]

        if bk["action_head_type"] == "mix":
            arm = squash(_dense(G, "action_head/continuous_head", readout, b)
                         .reshape(b, horizon, adim - 1))
            grip = _dense(G, "action_head/discrete_head", readout, b
                          ).reshape(b, horizon)
            if actions is None:
                return arm, grip
            target = actions.reshape(b, horizon, adim)
            if kw.get("clip_target"):
                target = target.clamp(-kw["max_action"], kw["max_action"])
            arm_loss = ((arm - target[..., :-1]) ** 2).flatten(1).mean(1)
            bce = F.binary_cross_entropy_with_logits(
                grip, target[..., -1], reduction="none").mean(1)
            return arm_loss * (adim - 1) + bce
        mean = squash(_dense(G, "action_head/mean_proj", readout, b)
                      .reshape(b, horizon, adim))
        if actions is None:
            return (mean,)
        target = actions.reshape(b, horizon, adim)
        if kw.get("clip_target"):
            target = target.clamp(-kw["max_action"], kw["max_action"])
        return ((mean - target) ** 2).flatten(1).mean(1) * adim

    def embed_tasks(self, t5_params, dino_params, ids, mask, initial):
        """Frozen encodes: instruction tokens (B, L, d) and the initial
        frame's class token (B, 1, width) or None."""
        with torch.no_grad():
            tokens = t5_encode(self.cfg["t5"], t5_params, ids, mask)
            cls = None
            if self.config["hypernet_kwargs"].get("use_initial_image"):
                cls = dino_encode(self.cfg["dinov2"], dino_params, "",
                                  initial, self.num)[:, :1]
        return tokens, cls

    def losses(self, P: Params, tokens, mask, cls, images, actions):
        ctx = self.context(P, tokens, mask, cls)
        return self.policy(self.generate(P, ctx), images, actions)

    # -- serving ----------------------------------------------------------

    def shared_blocks(self, P: Params) -> Params:
        """The shared blocks (the trunk) at their shapes, by block path."""
        return {n: P[flat_name(n)].reshape(self.blocks[n])
                for n in self.order if not self.generated[n]}

    def serve(self, *args, **kwargs):
        with torch.no_grad(), self.num.scope():
            return self._serve(*args, **kwargs)

    def _serve(self, P: Params, t5_params: Params, ids, mask, first, frames,
              side: int = 224, rows: int = 128):
        """One trajectory as a served episode: the instruction (ids, mask
        (L,)) and first frame (H, W, 3) generate the policy once; each
        frame (T, H, W, 3) is resized, centre-cropped and acted on. Returns
        the head's outputs per frame: (arm (T, H, A - 1), gripper logits
        (T, H))."""
        tokens = t5_encode(self.cfg["t5"], t5_params, ids[None], mask[None])
        cls = None
        if self.config["hypernet_kwargs"].get("use_initial_image"):
            trunk = {n[len("encoder/image_encoder/"):]: v for n, v in
                     self.shared_blocks(P).items()}
            cls = dino_encode(self.cfg["dinov2"], trunk, "",
                              resize(first[None], side), self.num)[:, :1]
        G = self.generate(P, self.context(P, tokens, mask[None], cls))
        arms, grips = [], []
        for lo in range(0, frames.shape[0], rows):
            x = center_crop(resize(frames[lo:lo + rows], side), side)
            n = x.shape[0]
            Gn = Weights({k: v.expand(n, *v.shape[1:]) if k in G.per_sample
                          else v for k, v in G.items()})
            Gn.per_sample = G.per_sample
            arm, grip = self.policy(Gn, x)
            arms.append(arm)
            grips.append(grip)
        return torch.cat(arms), torch.cat(grips)

    # -- the training step ------------------------------------------------

    def train(self, params: Params, t5_params: Params, dino_params: Params,
              batches: List[dict], first_step: int, rows: int = 32) -> dict:
        """Runs len(batches) optimizer steps from `params` (fp32, copied)
        at the step count `first_step`, with fresh AdamW moments and the
        EMA starting at the params. Returns {"losses": [...],
        "grad_norms": {leaf: norm of the first step's clipped gradient},
        "params": the params after the last step, "ema": the EMA after
        it}. Each batch is processed `rows` samples at a time."""
        cfg = self.config
        opt = cfg["optimizer"]
        P = {k: v.detach().float().clone().requires_grad_(True)
             for k, v in params.items()}
        mu = {k: torch.zeros_like(v, dtype=torch.bfloat16)
              for k, v in P.items()}
        nu = {k: torch.zeros_like(v) for k, v in P.items()}
        ema = {k: v.detach().clone() for k, v in P.items()}
        out = {"losses": []}
        with self.num.scope():
            self._train(P, mu, nu, ema, out, t5_params, dino_params, batches,
                        first_step, rows)
        out["params"] = {k: v.detach() for k, v in P.items()}
        out["ema"] = ema
        return out

    def _train(self, P, mu, nu, ema, out, t5_params, dino_params, batches,
               first_step, rows):
        cfg = self.config
        opt = cfg["optimizer"]
        for i, batch in enumerate(batches):
            step = first_step + i
            b = batch["actions"].shape[0]
            for v in P.values():
                v.grad = None
            total = 0.0
            for lo in range(0, b, rows):
                sl = slice(lo, lo + rows)
                tokens, cls = self.embed_tasks(
                    t5_params, dino_params, batch["ids"][sl],
                    batch["mask"][sl], batch["initial"][sl]
                    if cfg["hypernet_kwargs"].get("use_initial_image")
                    else None)
                loss = self.losses(P, tokens, batch["mask"][sl], cls,
                                   batch["images"][sl],
                                   batch["actions"][sl]).sum() / b
                loss.backward()
                total += float(loss.detach())
            out["losses"].append(total)
            grads = {k: (v.grad if v.grad is not None
                         else torch.zeros_like(v)) for k, v in P.items()}
            norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            if float(norm) >= opt["clip_gradient"]:
                grads = {k: g / norm * opt["clip_gradient"]
                         for k, g in grads.items()}
            if i == 0:
                out["grad_norms"] = {k: float(g.norm())
                                     for k, g in grads.items()}
            count = step + 1
            b1, b2, eps = 0.9, 0.999, 1e-8
            # the stored bf16 moment decays by b1 in bf16 (0.8984375): the
            # configuration's optimizer (optax's adamw, mu_dtype bfloat16)
            # multiplies the bf16 moment by a scalar that takes its dtype
            b1_stored = float(torch.tensor(b1, dtype=torch.bfloat16))
            with torch.no_grad():
                for k, g in grads.items():
                    shared = "image_encoder" in k.split("/")[0]
                    lr = schedule(opt["base_learning_rate" if shared
                                      else "learning_rate"], step)
                    wd = (opt["base_weight_decay"] if shared
                          else opt["weight_decay"]) if decayed(
                              opt["weight_decay_strategy"], k) else 0.0
                    m = b1_stored * mu[k].float() + (1 - b1) * g
                    nu[k] = b2 * nu[k] + (1 - b2) * g * g
                    u = (m / (1 - b1 ** count)) / (
                        torch.sqrt(nu[k] / (1 - b2 ** count)) + eps)
                    mu[k] = m.bfloat16()
                    P[k] -= lr * (u + wd * P[k])
                started = step >= cfg.get("EMA_start_step", 0)
                decay = cfg.get("EMA_decay", 0.999)
                for k in ema:
                    ema[k] = (decay * ema[k] + (1 - decay) * P[k].detach()
                              if started else P[k].detach().clone())


def schedule(spec: dict, step: int) -> float:
    """The learning rate after `step` updates: linear warm-up, then the
    named decay."""
    warm, peak = spec["warmup_steps"], spec["peak_value"]
    if step < warm:
        return spec["init_value"] + (peak - spec["init_value"]) * step / warm
    if spec["name"] == "rsqrt":
        t = spec.get("timescale", 10000)
        return peak / math.sqrt((step - warm + t) / t)
    if spec["name"] == "constant":
        return peak
    raise NotImplementedError(spec["name"])


def decayed(strategy: str, name: str) -> bool:
    """Which params take weight decay (the configuration's strategy)."""
    first = name.split("/")[0]
    if strategy == "v5":
        if "output_head" in first:
            return "kernel" in first
        return "image_encoder" in name
    if strategy in ("v1", "v4"):
        return "kernel" in name
    raise NotImplementedError(strategy)


def _grouped_conv(x, w, bias, stride: int, padding: int):
    """Per-sample convolution: x (B, C, H, W), w (B, kh, kw, cin, cout)."""
    outs = []
    for i in range(x.shape[0]):
        outs.append(F.conv2d(x[i:i + 1], w[i].permute(3, 2, 0, 1),
                             bias[i].reshape(-1), stride=stride,
                             padding=padding))
    return torch.cat(outs)


def _group_norm(x, scale, bias, groups: int = 32, eps: float = 1e-6):
    b, c, h, w = x.shape
    g = x.reshape(b, groups, -1)
    mu = g.mean(-1, keepdim=True)
    var = ((g - mu) ** 2).mean(-1, keepdim=True)
    y = ((g - mu) / torch.sqrt(var + eps)).reshape(b, c, h, w)
    return y * scale.reshape(b, c, 1, 1) + bias.reshape(b, c, 1, 1)


def gaps_by_leaf(program: Dict[str, float], reference: Dict[str, float],
                 keep: Optional[Dict[str, bool]] = None
                 ) -> Tuple[float, str, float]:
    """(the worst leaf's gap, its name, the median leaf's gap): a leaf's
    gap is |program norm - reference norm| over the larger of the
    reference's norm of that leaf and of the median leaf."""
    names = [k for k in reference if keep is None or keep[k]]
    ref = sorted(reference[k] for k in names)
    median = ref[len(ref) // 2]
    gaps = {k: abs(program[k] - reference[k]) / max(reference[k], median,
                                                     1e-30) for k in names}
    where = max(gaps, key=gaps.get)
    ordered = sorted(gaps.values())
    return gaps[where], where, ordered[len(ordered) // 2]
