"""dino_gemm_roofline: the frozen DINOv2 encode's layer GEMMs (ops/
dino_layer_train.py's no-residual forward over gemm_tma_kernel of
csrc/dino_layer.cu, four launches a layer: QKV, output, fc1, fc2) against
their roofline: the four GEMMs' least time at (batch x (1 + patches))
rows, operations at the bf16 peak or bytes at the memory's rate, per
four launches, over the kernel's device time, in %. Nothing is read
where the launches are not four a layer of every traced step."""
from perfbench.harness import counts


def read(ctx):
    if ctx.records is None:
        return None
    seconds, n = ctx.records.by_name(lambda name: "gemm_tma_kernel" in name)
    dino = ctx.cfg["dinov2"]
    if n == 0 or n != 4 * dino["num_hidden_layers"] * ctx.units:
        return None
    tokens = ctx.mix["batch_size"] * ((224 // dino["patch_size"]) ** 2 + 1)
    ops, nbytes = counts.dino_layer_gemm_kernel(dino, tokens)
    least = counts.least_seconds({"bfloat16": ops}, nbytes) * n / 4
    return 100.0 * least / seconds
