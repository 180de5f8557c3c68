"""One DINOv2 layer over a (B, S, H) batch, no-residual forward
(counterpart of hypervla_tpu/ops/dino_layer_train.py::dino_layer_train as
its undifferentiated call runs it: `_fwd_kernel` with with_res=False).

    LN1 -> q/k/v -> attention -> out-proj + LayerScale residual ->
    LN2 -> fc1 + exact GELU -> fc2 + LayerScale residual

The TPU kernel holds a whole layer in VMEM in one call; on Hopper the layer
is composed of hand-written kernels instead: the row LayerNorm and the bf16
GEMM with its bias / GELU / LayerScale-residual epilogues of
csrc/dino_layer.cu (the serving trunk's, which mask the ragged M = B*S and
take fc2's W2 in its (4H, H) layout), and the forward of
csrc/fused_attention.cu with the P store off. The rounding points are the
TPU kernel's: LN stats fp32 with one bf16 rounding, every dot an fp32 sum
rounded to bf16 plus the bf16 bias, softmax fp32, GELU exact in fp32 (the
TPU kernel's polynomial erf agrees with erff to 2e-6 before the bf16
rounding, so a rare one-ulp flip is expected), LayerScale residuals in bf16.

Used by the frozen conditioning encoder only, so this is a forward without
autograd: it raises if a gradient is asked for. The frozen encoder packs
each layer's operands once (`pack_layer_params`: bf16 weights, QKV
concatenated) and calls `dino_layer_train_packed`; `dino_layer_train` keeps
the JAX signature and packs per call. A layer call on CUDA tensors adds one
to `LAUNCHES["dino_layer_train_fwd"]`; the attention forward it launches is
counted there, not under `mha_fused_train_fwd`.
"""
import math
from typing import Dict

import torch

from hypervla_tpu_torch.ops import dino_layer as dl
from hypervla_tpu_torch.ops import fused_attention as fa

# pv row indices (fp32 per-layer vectors, packed (11, H))
(BQ, BK, BV, BO, B2, LN1_S, LN1_B, LN2_S, LN2_B, LS1, LS2) = range(11)

#: launches of the composed layer forward since the last reset
LAUNCHES: Dict[str, int] = {"dino_layer_train_fwd": 0}


def reset_launch_counts() -> None:
    LAUNCHES["dino_layer_train_fwd"] = 0


#: a packed layer's operands, in the order `pack_operands` returns them
OPERANDS = ("wqkv", "bqkv", "wo", "w1", "w2", "pv", "b1")


def pack_operands(wq, wk, wv, wo, w1, w2, pv, b1):
    """The JAX signature's operands as the layer's launches take them:
    (wqkv (H, 3H), bqkv (3H,), wo, w1, w2, pv, b1 (4H,)), contiguous."""
    pv = pv.contiguous()
    return (torch.cat([wq, wk, wv], dim=1),
            torch.cat([pv[BQ], pv[BK], pv[BV]]), wo.contiguous(),
            w1.contiguous(), w2.contiguous(), pv, b1[0].contiguous())


def _check_args(x, ops, heads):
    wqkv, bqkv, wo, w1, w2, pv, b1 = ops
    b, s, h = x.shape
    mlp = w1.shape[1]
    dl._check(x.dtype == torch.bfloat16, f"x must be bf16, got {x.dtype}")
    for w, shape in ((wqkv, (h, 3 * h)), (wo, (h, h)), (w1, (h, mlp)),
                     (w2, (mlp, h))):
        dl._check(w.dtype == torch.bfloat16 and tuple(w.shape) == shape,
                  f"weight {tuple(w.shape)} {w.dtype}, expected {shape} bf16")
    for v, shape in ((bqkv, (3 * h,)), (pv, (11, h)), (b1, (mlp,))):
        dl._check(v.dtype == torch.float32 and tuple(v.shape) == shape,
                  f"vector {tuple(v.shape)} {v.dtype}, expected {shape} fp32")
    dl._check(h % heads == 0, f"width {h} not divisible by {heads} heads")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *ops)):
        raise RuntimeError(
            "dino_layer_train is a forward without autograd (the frozen "
            "encoder's); its backward is not ported yet (ROADMAP.md B3)")


def _layer(x, ops, heads, eps, layer_norm, gemm, attention):
    wqkv, bqkv, wo, w1, w2, pv, b1 = ops
    b, s, h = x.shape
    rows = x.reshape(b * s, h)
    n1 = layer_norm(rows, pv[LN1_S], pv[LN1_B], eps)
    qkv = gemm(n1, wqkv, bqkv).view(b, s, 3 * h)
    ao = attention(qkv[..., :h], qkv[..., h:2 * h], qkv[..., 2 * h:], heads,
                   1.0 / math.sqrt(h // heads))
    x1 = gemm(ao.reshape(b * s, h), wo, pv[BO], "residual", rows, pv[LS1])
    n2 = layer_norm(x1, pv[LN2_S], pv[LN2_B], eps)
    hid = gemm(n2, w1, b1, "gelu")
    out = gemm(hid, w2, pv[B2], "residual", x1, pv[LS2])
    return out.view(b, s, h)


def _attention_reference(q, k, v, heads, scale):
    return fa.mha_fused_train_fwd_reference(q, k, v, heads, scale)[0]


def _attention_kernel(q, k, v, heads, scale):
    return fa._launch_fwd(q, k, v, heads, scale, store_p=False)[0]


def _reference_packed(x, ops, heads: int, eps: float):
    _check_args(x, ops, heads)
    return _layer(x.contiguous(), ops, heads, eps,
                  dl.layer_norm_rows_reference, dl.gemm_reference,
                  _attention_reference)


def dino_layer_train_reference(x, wq, wk, wv, wo, w1, w2, pv, b1,
                               heads: int, eps: float):
    """Plain PyTorch layer: the kernels' plain versions, in the same order."""
    return _reference_packed(x, pack_operands(wq, wk, wv, wo, w1, w2, pv, b1),
                             heads, eps)


def dino_layer_train_packed(x, ops, heads: int, eps: float):
    """One layer on operands packed by `pack_operands`; the launching
    wrapper (the plain version for CPU tensors)."""
    if dl._route(x, *ops) == "cpu":
        return _reference_packed(x, ops, heads, eps)
    _check_args(x, ops, heads)
    out = _layer(x.contiguous(), ops, heads, eps, dl.layer_norm_rows,
                 dl.gemm, _attention_kernel)
    LAUNCHES["dino_layer_train_fwd"] += 1
    return out


def dino_layer_train(x, wq, wk, wv, wo, w1, w2, pv, b1, heads: int,
                     eps: float):
    """One DINOv2 layer, no-residual forward.

    x: (B, S, H) bf16; wq/wk/wv/wo: (H, H) bf16; w1: (H, 4H) bf16;
    w2: (4H, H) bf16; pv: (11, H) fp32 packed
    [bq bk bv bo b2 ln1_s ln1_b ln2_s ln2_b ls1 ls2] with the layer scales
    already multiplied by layerscale_value; b1: (1, 4H) fp32.
    Returns (B, S, H) bf16.
    """
    return dino_layer_train_packed(
        x, pack_operands(wq, wk, wv, wo, w1, w2, pv, b1), heads, eps)


def pack_layer_params(params: Dict[str, torch.Tensor], prefix: str,
                      layerscale_value: float = 1.0):
    """One layer's operands, packed once by `pack_operands`, from its params
    keyed "<prefix>/attention/attention/query/kernel" and so on (Dense
    kernels in (in, out) layout), pv and b1 as hypervla_tpu/models/encoders/
    dinov2.py::_KernelLayerCollection packs them."""
    def g(name):
        return params[f"{prefix}/{name}"].float()

    att = "attention/attention"
    pv = torch.stack([
        g(f"{att}/query/bias"), g(f"{att}/key/bias"), g(f"{att}/value/bias"),
        g("attention/output/dense/bias"), g("mlp/fc2/bias"),
        g("norm1/scale"), g("norm1/bias"), g("norm2/scale"), g("norm2/bias"),
        layerscale_value * g("layer_scale1/lambda1"),
        layerscale_value * g("layer_scale2/lambda1"),
    ])
    weights = [g(f"{att}/query/kernel"), g(f"{att}/key/kernel"),
               g(f"{att}/value/kernel"), g("attention/output/dense/kernel"),
               g("mlp/fc1/kernel"), g("mlp/fc2/kernel")]
    return pack_operands(*(w.bfloat16() for w in weights), pv,
                         g("mlp/fc1/bias")[None])
