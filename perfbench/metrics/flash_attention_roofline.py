"""flash_attention_roofline: the served trunk's attention (ops/
flash_attention.py -> csrc/flash_attention.cu, every kernel whose name
begins with "flash_") against its roofline: for each chunk of frames of
the traced requests and each layer, the least time at (chunk, 1 +
patches, heads, head width), operations at the bf16 peak or bytes at the
memory's rate, over the device time of those kernels, in %. Nothing is
read unless the launches are one a layer of every chunk."""
from perfbench.harness import counts


def read(ctx):
    if ctx.records is None:
        return None
    seconds, n = ctx.records.by_name(
        lambda name: name.startswith("flash_") or " flash_" in name)
    dino = ctx.cfg["dinov2"]
    layers = dino["num_hidden_layers"]
    chunks = ctx.work["chunks"]
    if n == 0 or n != layers * len(chunks):
        return None
    seq = (224 // dino["patch_size"]) ** 2 + 1
    heads = dino["num_attention_heads"]
    least = 0.0
    for frames in chunks:
        ops, nbytes = counts.attention_kernel(
            frames, seq, heads, dino["hidden_size"] // heads)
        least += layers * counts.least_seconds({"bfloat16": ops}, nbytes)
    return 100.0 * least / seconds
