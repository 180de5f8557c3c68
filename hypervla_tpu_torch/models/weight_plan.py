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

The output heads are keyed by head name (`WeightPlan.head_name`): a
block's flat name, or under share_TF_output_head the policy ViT's
encoderblock_<i> blocks share the heads of encoderblock_0, named
"encoderblock" (hypervla_tpu/models/weight_plan.py, :273). A head's info
gives its init strategy: BIAS_INIT (zero kernel, the fresh base net in the
bias), or under init_strategy VARIANCE_INIT, for a generated block that is
no norm, a truncated-normal kernel of the block's fan-in variance and a
zero bias.
"""
import dataclasses
import math
import re
from typing import Dict, List, Optional, Tuple

import torch

from hypervla_tpu_torch.models.base_network import BaseNetwork
from hypervla_tpu_torch.models.encoders.pretrained import load_clip_weights

BIAS_INIT = 0  # InitOptions.BIAS_INIT
VARIANCE_INIT = 1  # InitOptions.VARIANCE_INIT


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
    share_tf_output_head: bool = False

    @property
    def total_param_num(self) -> int:
        return sum(math.prod(s) for s in self.param_shape.values())

    def dim(self, name: str) -> int:
        """The flat size of a block."""
        return math.prod(self.param_shape[name]) or 1

    @staticmethod
    def flat_name(path: str) -> str:
        return path.replace("/", "_")

    def head_name(self, name: str) -> str:
        """The output head a generated block comes from
        (hypervla_tpu/models/hypernetwork.py::head_name_for_block)."""
        return head_name_for_block(self.flat_name(name),
                                   self.share_tf_output_head)

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


def head_name_for_block(flat_name: str, share_tf_output_head: bool) -> str:
    if share_tf_output_head:
        return re.sub(r"encoderblock_\d+", "encoderblock", flat_name)
    return flat_name


def _head_info(name, shape, generated, hk):
    """A block's output-head info (hypervla_tpu/models/weight_plan.py::
    init_base_net's _head_info)."""
    strategy = int(hk.get("init_strategy", BIAS_INIT))
    if strategy not in (BIAS_INIT, VARIANCE_INIT):
        raise ValueError(f"{strategy} is not a valid InitOptions")
    keys = name.split("/")
    path = ".".join(keys)
    if ("encoder_norm" in path or "LayerNorm" in path or "GroupNorm" in path
            or not generated):
        strategy = BIAS_INIT
    variance = 0.0
    if strategy == VARIANCE_INIT and keys[-1] != "bias":
        if keys[-1] == "pos_embedding":
            variance = 0.02 ** 2
        elif keys[-2] == "out":
            variance = 1.0 / (shape[0] * shape[1])
        else:
            variance = 1.0 / shape[0]
        if not hk.get("scale_context_embedding", False):
            variance = variance / hk["context_embedding_dim"]
    return {"output_dim": math.prod(shape) if shape else 1,
            "generation_flag": generated, "init_strategy": strategy,
            "init_variance": float(variance)}


def _token_indices(names, hk, encoder_type):
    """Context-token index per block and the layer-token mask, in the JAX
    plan's order: each SmallStem module (its own token, generated unless
    the stem is shared), or the shared EfficientNet, or the shared DINOv2
    or CLIP image encoder (one token each, AssertionError where the
    config does not share them, as the JAX plan asserts), each
    Transformer_0 child, the other encoder children, the action head."""
    if hk.get("share_layer_index", False):
        return {n: 0 for n in names}, (True,)
    shared_modules = tuple(hk.get("shared_modules", ()))
    groups, mask = [], []
    def subtree(name):
        # the JAX plan indexes the encoder's tree by the module's name: an
        # encoder without it (the Octo transformer's) raises KeyError there
        if not any(n.startswith(f"encoder/{name}/") for n in names):
            raise KeyError(name)

    if encoder_type == "SmallStem":
        subtree("SmallStem_0")
        stem = sorted({n.split("/")[2] for n in names
                       if n.startswith("encoder/SmallStem_0/")})
        groups += [f"encoder/SmallStem_0/{m}" for m in stem]
        mask += [("SmallStem_0" not in shared_modules)] * len(stem)
    elif encoder_type == "EfficientNet":
        if "EfficientNet" not in shared_modules:
            raise AssertionError("Only shared EfficientNet is supported")
        subtree("EfficientNet_0")
        groups.append("encoder/EfficientNet_0")
        mask.append(False)
    elif encoder_type in ("DINOv2", "CLIP"):
        if "image_encoder" not in shared_modules:
            raise AssertionError("Pretrained image encoders must be shared")
        subtree("image_encoder")
        groups.append("encoder/image_encoder")
        mask.append(False)
    tf = sorted({n.split("/")[2] for n in names
                 if n.startswith("encoder/Transformer_0/")})
    n_fixed = len(groups)
    groups += [f"encoder/Transformer_0/{m}" for m in tf]
    enc_children = sorted({n.split("/")[1] for n in names
                           if n.startswith("encoder/")})
    groups += [f"encoder/{m}" for m in enc_children
               if m not in ("Transformer_0", "image_encoder", "SmallStem_0",
                            "EfficientNet_0")]
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
    batch: "image" (H, W) of its primary camera, where it has one,
    "patch_embeddings" (tokens, dim) of its observation's precomputed
    patch embeddings (a Siglip policy's), where it has them, and
    "instruction" (L, token_dim) of its instruction's token embedding."""
    shapes = {}
    batch = example_batch or {}
    image = (batch.get("observation") or {}).get("image_primary")
    if image is not None:
        shapes["image"] = tuple(image.shape[-3:-1])
    patches = (batch.get("observation") or {}).get("patch_embeddings")
    if patches is not None:
        shapes["patch_embeddings"] = tuple(patches.shape[-2:])
    tokens = ((batch.get("task") or {}).get("language_instruction")
              or {}).get("token_embedding")
    if tokens is not None:
        shapes["instruction"] = tuple(tokens.shape[-2:])
    return shapes


def build_weight_plan(config: dict, base_net: BaseNetwork) -> WeightPlan:
    hk = config["hypernet_kwargs"]
    share_tf = bool(hk.get("share_TF_output_head", False))
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
    info = {}
    for n in names:
        # under share_TF_output_head the first block of a head (the sorted
        # names put encoderblock_0 first) gives its info, as the JAX plan
        # keeps encoderblock_0's under the shared name
        info.setdefault(head_name_for_block(WeightPlan.flat_name(n), share_tf),
                        _head_info(n, shapes[n], flags[n], hk))
    return WeightPlan(names, shapes, flags, token_index, layer_token_mask,
                      len(layer_token_mask), info,
                      ("encoder", "image_encoder")
                      if encoder_type in ("DINOv2", "CLIP") else None,
                      share_tf)


def init_base_net(config: dict, generator: torch.Generator,
                  example_batch: Optional[dict] = None):
    """Builds the base network for the shapes of example_batch (None: 224
    x 224 frames, `input_shapes`) and a fresh init of its params.

    Returns (base_net, init_params, plan); init_params is a flat dict of
    fp32 CPU tensors keyed by block path. Pretrained DINOv2 weights are not
    in the repository, so the shared trunk keeps its random init; a CLIP
    trunk takes models/encoders/pretrained.py::load_clip_weights where
    there are any (the JAX plan's load_clip_weights), else its random
    init too."""
    base_net = BaseNetwork(**config["base_net_kwargs"],
                           octo_kwargs=config.get("model"),
                           input_shapes=input_shapes(example_batch))
    plan = build_weight_plan(config, base_net)
    specs = base_net.specs()
    # draw in the plan's order so a seed fixes every value
    params = {n: specs[n][1](specs[n][0], generator).float()
              for n in plan.names}
    if base_net.encoder.encoder_type == "CLIP":
        weights = load_clip_weights()
        for key, value in (weights or {}).items():
            name = f"encoder/image_encoder/{key}"
            if name not in params or params[name].shape != value.shape:
                raise ValueError(f"pretrained CLIP leaf {key} does not fit "
                                 "the base net's CLIP")
            params[name] = value.float().cpu()
    return base_net, params, plan
