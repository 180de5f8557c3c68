"""Weights made from the seed, on the device, in one draw: every leaf is a
slice of one normal sample, scaled (and offset) by a rule on its name and
shape. The same seed and device give the same weights, so the reference
can make them again after the window has closed.

The rule, per block (a base-net block's path, or a frozen encoder's leaf):
  * norm scales, LayerScale vectors and T5's RMS weights: 1 + 0.02 N;
  * biases, tokens and position tables: 0.02 N;
  * kernels: N / sqrt(fan in) (T5's query also over sqrt(d_kv), as T5
    has no 1/sqrt(d) in its attention); T5's embedding: N;
  * a generated block's output head: its bias is the block's own value
    (the bias-init protocol), its kernel 0.3 x the block's scale, so that
    the generated weights vary by task.
"""
import math
from typing import Dict, Iterable, Tuple

import torch

Shapes = Dict[str, tuple]

#: the share of a block's scale that its output head's kernel gets
HEAD_KERNEL_SHARE = 0.3


def block_rule(path: str, shape: tuple, d_kv: int = 64
               ) -> Tuple[float, float]:
    """(offset, std) of a block's values; d_kv: T5's head width."""
    last = path.split("/")[-1]
    if last in ("scale", "lambda1", "weight"):
        return 1.0, 0.02
    if last == "shared_embedding":
        return 0.0, 1.0
    if last == "relative_attention_bias":
        return 0.0, 0.05
    if last == "kernel":
        parent = path.split("/")[-2]
        if parent in ("query", "key", "value") and len(shape) == 3:
            fan_in = shape[0]
        else:
            fan_in = math.prod(shape[:-1])
        std = 1.0 / math.sqrt(fan_in)
        if parent == "q" and "SelfAttention" in path:
            std /= math.sqrt(d_kv)
        return 0.0, std
    return 0.0, 0.02


def plan(trainable: Shapes, blocks: Shapes, block_order: Iterable[str],
         frozen: Dict[str, Shapes], d_kv: int = 64) -> Dict[str, list]:
    """{group: [(name, shape, pieces)]}: each leaf as pieces (numel,
    offset, std) laid end to end. `trainable` are the hypernetwork's
    params, `blocks` the base net's blocks by path (for the output heads
    and the shared blocks), `frozen` the frozen encoders' leaves by
    group."""
    flat = {b.replace("/", "_"): b for b in blocks}
    out = {"params": []}
    for name, shape in trainable.items():
        first = name.split("/")[0]
        last = name.split("/")[-1]
        if first == "output_head":  # "full": one head over every block
            pieces = []
            for b in block_order:
                off, std = block_rule(b, blocks[b])
                n = math.prod(blocks[b])
                if last == "kernel":
                    pieces.append((n, 0.0, HEAD_KERNEL_SHARE * std))
                else:
                    pieces.append((n, off, std))
            if last == "kernel":
                pieces = pieces * shape[0]
            out["params"].append((name, shape, pieces))
            continue
        if first.startswith("output_head_"):
            block = flat[first[len("output_head_"):]]
            off, std = block_rule(block, blocks[block])
            if last == "kernel":
                off, std = 0.0, HEAD_KERNEL_SHARE * std
        elif name in flat:
            off, std = block_rule(flat[name], blocks[flat[name]])
        else:
            off, std = block_rule(name, shape)
        out["params"].append((name, shape, [(math.prod(shape), off, std)]))
    for group, leaves in frozen.items():
        out[group] = [(n, s, [(math.prod(s),) + block_rule(n, s, d_kv)])
                      for n, s in leaves.items()]
    return out


def make(layout: Dict[str, list], seed: int, device) -> Dict[str, dict]:
    """{group: {name: fp32 tensor}} from one normal draw on `device`; each
    leaf a tensor of its own."""
    total = sum(n for leaves in layout.values() for _, _, pieces in leaves
                for n, _, _ in pieces)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    draw = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for group, leaves in layout.items():
        out[group] = {}
        for name, shape, pieces in leaves:
            size = sum(n for n, _, _ in pieces)
            leaf = draw[at:at + size]
            if len(pieces) == 1:
                _, off, std = pieces[0]
                leaf.mul_(std).add_(off)
            else:
                pos = 0
                for n, off, std in pieces:
                    leaf[pos:pos + n].mul_(std).add_(off)
                    pos += n
            out[group][name] = leaf.view(shape).clone()
            at += size
    del draw
    return out
