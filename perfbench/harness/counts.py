"""The yardstick's arithmetic: the peaks of the card, and the operations
and bytes of a configuration's step and of the kernels' functions,
counted from shapes. A matmul of (m, k) by (k, n) is 2mnk operations.
Backward passes count the input gradient only where the input needs one
(frozen parts and pixels take none) and the weight gradient of every
trained weight; nothing recomputed is counted. Bytes count each input
of a function read once and each output written once."""
from typing import Dict

#: NVIDIA H100 SXM, dense rates (the data sheet), at the 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def mm(m: int, n: int, k: int) -> int:
    return 2 * m * n * k


def attention(batch: int, seq: int, heads: int, head_dim: int) -> int:
    """Q K^T and P V of one multi-head attention, forward."""
    return 2 * mm(seq, seq, head_dim) * batch * heads


def least_seconds(flops: Dict[str, float], nbytes: float = 0.0) -> float:
    """The least time the card could take: the operations at the peak of
    their precision, or the bytes at the memory's rate, whichever is
    longer."""
    compute = sum(f / PEAK_FLOPS[p] for p, f in flops.items())
    return max(compute, nbytes / PEAK_BYTES)


# ------------------------------- encoders --------------------------------


def t5_forward(t5: dict, batch: int, seq: int) -> int:
    d, inner, ff = t5["d_model"], t5["num_heads"] * t5["d_kv"], t5["d_ff"]
    per_layer = (mm(seq, 3 * inner, d) + mm(seq, d, inner)
                 + mm(seq, ff, d) + mm(seq, d, ff)
                 + attention(1, seq, t5["num_heads"], t5["d_kv"]))
    return batch * t5["num_layers"] * per_layer


def dino_layer_gemms(dino: dict, tokens: int) -> int:
    """The four GEMMs of one DINOv2 layer over `tokens` rows, forward."""
    d = dino["hidden_size"]
    m = dino["mlp_ratio"] * d
    return (mm(tokens, 3 * d, d) + mm(tokens, d, d) + mm(tokens, m, d)
            + mm(tokens, d, m))


def dino_forward(dino: dict, batch: int, side: int = 224) -> Dict[str, int]:
    """{"patch": the patch embedding, "layers": the layer GEMMs, "attention":
    the attention products} of a DINOv2 forward over `batch` frames."""
    ps, d = dino["patch_size"], dino["hidden_size"]
    seq = (side // ps) ** 2 + 1
    heads = dino["num_attention_heads"]
    layers = dino["num_hidden_layers"]
    return {"patch": mm(batch * (seq - 1), d, ps * ps * 3),
            "layers": layers * dino_layer_gemms(dino, batch * seq),
            "attention": layers * attention(batch, seq, heads, d // heads)}


def transformer_forward(batch: int, seq: int, d: int, layers: int, mlp: int,
                        heads: int) -> int:
    per_layer = (mm(seq, 4 * d, d) + mm(seq, mlp, d) + mm(seq, d, mlp)
                 + attention(1, seq, heads, d // heads))
    return batch * layers * per_layer


def smallstem_forward(vk: dict, batch: int, side: int = 224):
    """(operations of the conv stem over `batch` frames, of its first
    convolution alone, tokens out)."""
    total, first, c_in = 0, 0, 3
    for i, f in enumerate(vk["cnn_channels"]):
        side = (side + 2 - 3) // 2 + 1
        ops = mm(batch * side * side, f, 9 * c_in)
        first = first or ops
        total += ops
        c_in = f
    patch = vk["patch_size"] // 16
    side //= patch
    total += mm(batch * side * side, vk["hidden_dim"], patch * patch * c_in)
    return total, first, side * side


def base_net_params(cfg: dict, blocks: Dict[str, tuple]) -> int:
    """Generated params of one task (shared blocks left out)."""
    shared = tuple(cfg["config"]["hypernet_kwargs"].get("shared_modules", ()))
    total = 0
    for path, shape in blocks.items():
        if not any(m in key for m in shared for key in path.split("/")):
            n = 1
            for s in shape:
                n *= s
            total += n
    return total


# ------------------------------ whole steps ------------------------------


def policy_tokens(cfg: dict) -> int:
    vk = cfg["config"]["base_net_kwargs"]["vit_kwargs"]
    if vk["encoder_type"] == "DINOv2":
        return (224 // cfg["dinov2"]["patch_size"]) ** 2 + 1
    return smallstem_forward(vk, 1)[2] + 1


def hypernet_forward(cfg: dict, blocks: Dict[str, tuple], batch: int,
                     instr_len: int):
    """(the input projections of the frozen embeddings, the rest) of the
    hypernetwork's forward."""
    hk = cfg["config"]["hypernet_kwargs"]
    c = hk["context_embedding_dim"]
    ce = hk["context_encoder_kwargs"]
    seq = instr_len + 1 + int(bool(hk.get("use_initial_image")))
    inputs = batch * mm(instr_len, c, cfg["t5"]["d_model"])
    if hk.get("use_initial_image"):
        inputs += batch * mm(1, c, cfg["dinov2"]["hidden_size"])
    rest = transformer_forward(batch, seq, c, ce["num_layers"],
                               ce["mlp_dim"], ce["num_attention_heads"])
    return inputs, rest + mm(batch, base_net_params(cfg, blocks), c)


def train_step(cfg: dict, blocks: Dict[str, tuple], batch: int,
               instr_len: int) -> Dict[str, float]:
    """{precision: operations} of one training step of the configuration:
    the frozen encodes forward, everything trained forward and backward
    (backward = twice the forward for every matmul whose input needs a
    gradient, once where only the weight does)."""
    config = cfg["config"]
    vk = config["base_net_kwargs"]["vit_kwargs"]
    trunk_dtype = ("bfloat16" if vk.get("encoder_dtype") == "bfloat16"
                   else "float32")
    out = {"bfloat16": 0.0, "float32": 0.0}
    out["float32"] += t5_forward(cfg["t5"], batch, instr_len)
    if config["hypernet_kwargs"].get("use_initial_image"):
        out[trunk_dtype] += sum(dino_forward(cfg["dinov2"], batch).values())
    # the hypernetwork: its input (the frozen embeddings) takes no gradient
    inputs, rest = hypernet_forward(cfg, blocks, batch, instr_len)
    out["float32"] += 2 * inputs + 3 * rest
    hd = vk["hidden_dim"]
    seq = policy_tokens(cfg)
    if vk["encoder_type"] == "DINOv2":
        dino = dino_forward(cfg["dinov2"], batch)
        # the patch embedding's input is pixels: its weight gradient only
        out[trunk_dtype] += (2 * dino["patch"] + 3 * dino["layers"]
                             + 3 * dino["attention"])
        width = cfg["dinov2"]["hidden_size"]
    else:
        stem, first, _ = smallstem_forward(vk, batch)
        out["float32"] += 3 * stem - first
        width = 0
    policy = transformer_forward(batch, seq, hd, vk["num_layers"],
                                 vk["mlp_dim"], vk["num_heads"])
    policy += batch * mm(seq - 1, hd, width) if width else 0
    bk = config["base_net_kwargs"]
    policy += batch * mm(1, bk["action_horizon"] * bk["action_dim"], hd)
    out["float32"] += 3 * policy
    return out


def replay_request(cfg: dict, blocks: Dict[str, tuple], frames: int,
                   instr_len: int) -> Dict[str, float]:
    """{precision: operations} of one replayed trajectory: the reset (T5,
    the first frame through the fp32 trunk, the hypernetwork) and every
    frame through the served trunk, the policy and its head, forward."""
    config = cfg["config"]
    vk = config["base_net_kwargs"]["vit_kwargs"]
    trunk_dtype = ("bfloat16" if vk.get("encoder_dtype") == "bfloat16"
                   else "float32")
    out = {"bfloat16": 0.0, "float32": 0.0}
    out["float32"] += t5_forward(cfg["t5"], 1, instr_len)
    inputs, rest = hypernet_forward(cfg, blocks, 1, instr_len)
    out["float32"] += inputs + rest
    hd = vk["hidden_dim"]
    seq = policy_tokens(cfg)
    if vk["encoder_type"] == "DINOv2":
        if config["hypernet_kwargs"].get("use_initial_image"):
            out["float32"] += sum(dino_forward(cfg["dinov2"], 1).values())
        out[trunk_dtype] += sum(dino_forward(cfg["dinov2"], frames).values())
        width = cfg["dinov2"]["hidden_size"]
    else:
        out["float32"] += smallstem_forward(vk, frames)[0]
        width = 0
    policy = transformer_forward(frames, seq, hd, vk["num_layers"],
                                 vk["mlp_dim"], vk["num_heads"])
    policy += frames * mm(seq - 1, hd, width) if width else 0
    bk = config["base_net_kwargs"]
    policy += frames * mm(1, bk["action_horizon"] * bk["action_dim"], hd)
    out["float32"] += policy
    return out


# ----------------------------- kernel functions --------------------------


def attention_kernel(batch: int, seq: int, heads: int, head_dim: int,
                     backward: bool = False, elem: int = 2):
    """(operations, bytes) of one attention function call on bf16 (B, S,
    H, D) operands: the forward reads Q, K, V and writes O; the backward
    reads Q, K, V, O and dO and writes dQ, dK, dV (dV = P^T dO, dP = dO
    V^T, dQ = dS K, dK = dS^T Q)."""
    size = batch * seq * heads * head_dim * elem
    fwd = attention(batch, seq, heads, head_dim)
    if backward:
        return 2 * fwd, 8 * size
    return fwd, 4 * size


def dino_layer_gemm_kernel(dino: dict, tokens: int, elem: int = 2):
    """(operations, bytes) of the four forward GEMMs of one DINOv2 layer
    over `tokens` rows: inputs (activations and weights) read once,
    outputs written once."""
    d = dino["hidden_size"]
    m = dino["mlp_ratio"] * d
    shapes = ((tokens, 3 * d, d), (tokens, d, d), (tokens, m, d),
              (tokens, d, m))
    nbytes = sum((a * k + k * n + a * n) * elem for a, n, k in shapes)
    return dino_layer_gemms(dino, tokens), nbytes
