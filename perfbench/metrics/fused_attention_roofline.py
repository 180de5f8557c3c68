"""fused_attention_roofline: the fused training attention (ops/
fused_attention.py -> csrc/fused_attention.cu: mha_fwd_kernel,
mha_bwd_dq_kernel and mha_bwd_dkv_kernel) against its roofline: every
launch's least time at the trunk's (batch, 1 + patches, heads, head
width), the larger of operations over the bf16 peak and bytes over the
memory's rate, over the device time of those kernels, in %. The frozen
encode's layers launch the same forward kernel at the same shape."""
from perfbench.harness import counts


def read(ctx):
    if ctx.records is None:
        return None
    fwd_s, n_fwd = ctx.records.by_name(lambda n: "mha_fwd_kernel" in n)
    dq_s, n_bwd = ctx.records.by_name(lambda n: "mha_bwd_dq_kernel" in n)
    dkv_s, n_dkv = ctx.records.by_name(lambda n: "mha_bwd_dkv_kernel" in n)
    if n_fwd == 0 or n_bwd != n_dkv:
        return None
    dino = ctx.cfg["dinov2"]
    shape = (ctx.mix["batch_size"], (224 // dino["patch_size"]) ** 2 + 1,
             dino["num_attention_heads"],
             dino["hidden_size"] // dino["num_attention_heads"])
    least = 0.0
    for n, backward in ((n_fwd, False), (n_bwd, True)):
        ops, nbytes = counts.attention_kernel(*shape, backward=backward)
        least += n * counts.least_seconds({"bfloat16": ops}, nbytes)
    return 100.0 * least / (fwd_s + dq_s + dkv_s)
