"""WeightPlan: the base-net metadata (counterpart of
hypervla_tpu/models/weight_plan.py::init_base_net).

The JAX package derives the plan from a flax init of the base network; the
port derives the same plan from the config, in the same order: blocks are
listed in the order jax flattens the param dict (keys sorted at every
level, so "encoderblock_10" precedes "encoderblock_2"). For every block the
plan gives its shape, whether the hypernetwork generates it or shares it
across tasks (`shared_modules` substring match), its context-token index
and its output-head info; `layer_token_mask` says which context tokens
generate weights.
"""
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

from hypervla_tpu_torch.models.base_network import BaseNetwork

BIAS_INIT = 0  # InitOptions.BIAS_INIT


@dataclasses.dataclass
class WeightPlan:
    names: List[str]                      # block paths, in jax order
    param_shape: Dict[str, Tuple[int, ...]]
    generation_flag: Dict[str, bool]
    token_index: Dict[str, int]
    layer_token_mask: Tuple[bool, ...]
    block_num: int
    output_head_info: Dict[str, dict]     # keyed by flat name
    # where the shared pretrained image encoder's subtree sits in the
    # base-net tree (None without one): delta-decay walks it
    pretrained_block_path: Optional[Tuple[str, ...]] = None

    @property
    def total_param_num(self) -> int:
        return sum(math.prod(s) for s in self.param_shape.values())

    @staticmethod
    def flat_name(path: str) -> str:
        return path.replace("/", "_")

    def flat_name_table(self) -> dict:
        """The block paths nested as the base-net tree, each leaf its flat
        name (the JAX plan's metadata "flat_name")."""
        table: dict = {}
        for name in self.names:
            *parents, last = name.split("/")
            node = table
            for key in parents:
                node = node.setdefault(key, {})
            node[last] = self.flat_name(name)
        return table


def _token_indices(names, hk, encoder_type):
    """Context-token index per block and the layer-token mask, in the JAX
    plan's order: each SmallStem module (its own token, generated unless
    the stem is shared) or the shared DINOv2 image encoder, each
    Transformer_0 child, the other encoder children, the action head."""
    if hk.get("share_layer_index", False):
        return {n: 0 for n in names}, (True,)
    shared_modules = tuple(hk.get("shared_modules", ()))
    groups, mask = [], []
    if encoder_type == "SmallStem":
        stem = sorted({n.split("/")[2] for n in names
                       if n.startswith("encoder/SmallStem_0/")})
        groups += [f"encoder/SmallStem_0/{m}" for m in stem]
        mask += [("SmallStem_0" not in shared_modules)] * len(stem)
    elif encoder_type == "DINOv2":
        if "image_encoder" not in shared_modules:
            raise ValueError("Pretrained image encoders must be shared")
        groups.append("encoder/image_encoder")
        mask.append(False)
    tf = sorted({n.split("/")[2] for n in names
                 if n.startswith("encoder/Transformer_0/")})
    n_fixed = len(groups)
    groups += [f"encoder/Transformer_0/{m}" for m in tf]
    enc_children = sorted({n.split("/")[1] for n in names
                           if n.startswith("encoder/")})
    groups += [f"encoder/{m}" for m in enc_children
               if m not in ("Transformer_0", "image_encoder", "SmallStem_0")]
    groups.append("action_head")
    mask += [True] * (len(groups) - n_fixed)
    index = {}
    for n in names:
        matches = [i for i, g in enumerate(groups)
                   if n == g or n.startswith(g + "/")]
        index[n] = matches[0]
    return index, tuple(mask)


def input_shapes(example_batch: Optional[dict]) -> dict:
    """The shapes the base net's params depend on, read off an example
    batch: "image" (H, W) of its primary camera, where it has one, and
    "instruction" (L, token_dim) of its instruction's token embedding."""
    shapes = {}
    batch = example_batch or {}
    image = (batch.get("observation") or {}).get("image_primary")
    if image is not None:
        shapes["image"] = tuple(image.shape[-3:-1])
    tokens = ((batch.get("task") or {}).get("language_instruction")
              or {}).get("token_embedding")
    if tokens is not None:
        shapes["instruction"] = tuple(tokens.shape[-2:])
    return shapes


def build_weight_plan(config: dict, base_net: BaseNetwork) -> WeightPlan:
    hk = config["hypernet_kwargs"]
    if hk.get("share_TF_output_head", False):
        raise NotImplementedError(
            "share_TF_output_head is not ported yet (ROADMAP.md A8, the "
            "rest of the train step)")
    if int(hk.get("init_strategy", BIAS_INIT)) != BIAS_INIT:
        raise NotImplementedError(
            "init_strategy VARIANCE_INIT is not ported yet (ROADMAP.md A8, "
            "the rest of the train step)")
    specs = base_net.specs()
    names = sorted(specs, key=lambda n: tuple(n.split("/")))
    shapes = {n: tuple(specs[n][0]) for n in names}
    shared_modules = tuple(hk.get("shared_modules", ()))
    if hk.get("share_all_params", False):
        flags = {n: False for n in names}
    else:
        flags = {n: not any(m in key for m in shared_modules
                            for key in n.split("/")) for n in names}
    encoder_type = base_net.encoder.encoder_type
    token_index, layer_token_mask = _token_indices(names, hk, encoder_type)
    info = {
        WeightPlan.flat_name(n): {
            "output_dim": math.prod(shapes[n]) if shapes[n] else 1,
            "generation_flag": flags[n],
            "init_strategy": BIAS_INIT,
            "init_variance": 0.0,
        }
        for n in names
    }
    return WeightPlan(names, shapes, flags, token_index, layer_token_mask,
                      len(layer_token_mask), info,
                      ("encoder", "image_encoder")
                      if encoder_type in ("DINOv2", "CLIP") else None)


def init_base_net(config: dict, generator: torch.Generator,
                  example_batch: Optional[dict] = None):
    """Builds the base network for the shapes of example_batch (None: 224
    x 224 frames, `input_shapes`) and a fresh init of its params.

    Returns (base_net, init_params, plan); init_params is a flat dict of
    fp32 CPU tensors keyed by block path. Pretrained DINOv2 weights are not
    in the repository, so the shared trunk keeps its random init."""
    base_net = BaseNetwork(**config["base_net_kwargs"],
                           input_shapes=input_shapes(example_batch))
    plan = build_weight_plan(config, base_net)
    specs = base_net.specs()
    # draw in the plan's order so a seed fixes every value
    params = {n: specs[n][1](specs[n][0], generator).float()
              for n in plan.names}
    return base_net, params, plan
