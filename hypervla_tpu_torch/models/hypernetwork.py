"""HyperNetwork: task -> base-network weights (counterpart of
hypervla_tpu/models/hypernetwork.py).

The context encoder runs over [task tokens | initial-image token(s) |
goal-image tokens | layer tokens] under the JAX package's attention mask;
the layer-token outputs, optionally scaled by 1/sqrt(context_dim), feed the
fan-out. Two generation strategies:

  * "block": one layer token per context-token group of the plan; every
    generated block keeps its own output head (kernel, bias), or with
    share_TF_output_head the policy ViT's layers share encoderblock_0's
    (models/weight_plan.py::WeightPlan.head_name); the heads sharing a
    context token are concatenated into one [context_dim, sum(dims)]
    matrix and applied as one matmul per group;
  * "full": one layer token and one output head (`output_head`) over the
    flat vector of every base-net param, shared blocks included, walked in
    the plan's block order (the JAX package's block_entries order).

output_head_bias=False drops the output heads' biases. Shared blocks (the
DINOv2 trunk) are flat params copied into the base-net tree unchanged.

Goal images (include_goal_image): the task's image_primary through a
SmallStem16 whose GroupNorms have no scale or bias
(models/vit_encoders.py::SmallStem), projected to the context width
(goal_image_token_projection) with a learned position table, attended
where the task's pad_mask_dict image_primary holds.

In training (given a models/draws.py::Draws) the JAX module's dropout
runs: image_dropout on the initial image's patch embeddings, the context
encoder's dropout_rate (after its position table, in every block's
attention output and MLP) and attention_dropout_rate (on its attention
weights), embedding_dropout_rate on the context embedding, and in "block"
generation final_dropout_rate on each group's packed params. Absent
context-encoder rates are the JAX Transformer's defaults (0.1).

In training the hypernetwork runs over the whole batch; `per_sample_view`
lays each sample's generated blocks out so that the base net's ops
broadcast over the sample axis (the JAX package vmaps a per-sample loss).

Param names follow the JAX package: task_token_projection,
task_pos_embedding, initial_image_projection, initial_image_pos_embedding,
SmallStem16_0/..., goal_image_token_projection, goal_image_pos_embedding,
layer_pos_embedding, context_encoder/..., output_head_<head>/{kernel,bias}
and <block> for each shared block (block = its path joined by "_"); under
"full" one output_head/{kernel,bias}.
"""
import math
from typing import Dict, Optional, Tuple

import torch

from hypervla_tpu_torch.models import layers
from hypervla_tpu_torch.models.draws import Draws, dropout
from hypervla_tpu_torch.models.transformer import transformer, transformer_specs
from hypervla_tpu_torch.models.vit_encoders import SmallStem
from hypervla_tpu_torch.models.weight_plan import VARIANCE_INIT, WeightPlan

Params = Dict[str, torch.Tensor]

#: the JAX Transformer's dropout rates where the config leaves them out
CONTEXT_ENCODER_DROPOUT = 0.1
#: the goal-image stem (hypervla_tpu/models/vit_encoders.py::SmallStem16
#: with learnable_norm=False) and its param prefix
GOAL_STEM = SmallStem(patch_size=16, learnable_norm=False)
GOAL_PREFIX = "SmallStem16_0"


class HyperNetwork:
    def __init__(self, plan: WeightPlan, hypernet_kwargs: dict):
        hk = hypernet_kwargs
        self.strategy = hk.get("generation_strategy", "full")
        if self.strategy not in ("block", "full"):
            raise ValueError(
                f"unknown generation_strategy {self.strategy}")
        self.plan = plan
        self.hk = hk
        self.context_dim = hk["context_embedding_dim"]
        self.layer_token_num = (plan.block_num if self.strategy == "block"
                                else 1)
        self.use_initial_image = hk.get("use_initial_image", False)
        self.include_goal_image = hk.get("include_goal_image", False)
        self.output_head_bias = hk.get("output_head_bias", True)
        ce = hk["context_encoder_kwargs"]
        self.ce_dropout = ce.get("dropout_rate", CONTEXT_ENCODER_DROPOUT)
        self.ce_attention_dropout = ce.get("attention_dropout_rate",
                                           CONTEXT_ENCODER_DROPOUT)
        groups: Dict[int, list] = {}
        for name in plan.names:
            if plan.generation_flag[name] and self.strategy == "block":
                groups.setdefault(plan.token_index[name], []).append(name)
        self.packed_groups = tuple(sorted(groups.items()))

    def specs(self, instr_len: int, token_dim: int, image_tokens: int,
              patch_dim: int, goal_shape: Optional[tuple] = None
              ) -> Dict[str, Tuple[tuple, layers.Init]]:
        """Param shapes and initializers (output-head kernels start at zero,
        or with VARIANCE_INIT from their head's variance; biases and shared
        blocks are overwritten by the bias-init protocol in
        HyperVLA.from_config). goal_shape: the (H, W) of the task's goal
        images, with include_goal_image."""
        c = self.context_dim
        ce = self.hk["context_encoder_kwargs"]
        specs = {
            "task_token_projection/kernel": ((token_dim, c),
                                             layers.lecun_normal),
            "task_token_projection/bias": ((c,), layers.zeros),
            "task_pos_embedding": ((1, instr_len, c), layers.normal(0.02)),
            "layer_pos_embedding": ((1, self.layer_token_num, c),
                                    layers.normal(0.02)),
        }
        ctx_len = instr_len + self.layer_token_num
        if self.use_initial_image:
            specs.update({
                "initial_image_projection/kernel": ((patch_dim, c),
                                                    layers.lecun_normal),
                "initial_image_projection/bias": ((c,), layers.zeros),
                "initial_image_pos_embedding": ((1, image_tokens, c),
                                                layers.normal(0.02)),
            })
            ctx_len += image_tokens
        if self.include_goal_image:
            if goal_shape is None:
                raise ValueError("include_goal_image: the example batch's "
                                 "task needs its image_primary")
            n_goal = GOAL_STEM.num_tokens(*goal_shape)
            specs.update(GOAL_STEM.specs(GOAL_PREFIX))
            specs.update({
                "goal_image_token_projection/kernel": (
                    (GOAL_STEM.num_features, c), layers.lecun_normal),
                "goal_image_token_projection/bias": ((c,), layers.zeros),
                "goal_image_pos_embedding": ((1, n_goal, c),
                                             layers.normal(0.02)),
            })
            ctx_len += n_goal
        specs.update(transformer_specs(
            "context_encoder", c, ce["num_layers"], ce["mlp_dim"],
            ce["num_attention_heads"],
            ctx_len if ce.get("add_position_embedding", False) else 0))
        plan = self.plan
        if self.strategy == "full":
            specs["output_head/kernel"] = ((c, plan.total_param_num),
                                           layers.zeros)
            if self.output_head_bias:
                specs["output_head/bias"] = ((plan.total_param_num,),
                                             layers.zeros)
        for name in plan.names:
            if plan.generation_flag[name]:
                if self.strategy == "full":
                    continue
                head = plan.head_name(name)
                info = plan.output_head_info[head]
                init = layers.zeros
                if (info["init_strategy"] == VARIANCE_INIT
                        and info["init_variance"] > 0):
                    init = layers.truncated_normal(
                        float(info["init_variance"]) ** 0.5)
                specs[f"output_head_{head}/kernel"] = (
                    (c, info["output_dim"]), init)
                if self.output_head_bias:
                    specs[f"output_head_{head}/bias"] = (
                        (info["output_dim"],), layers.zeros)
            else:
                specs[WeightPlan.flat_name(name)] = (
                    (plan.dim(name),), layers.truncated_normal(0.02))
        return specs

    def context_embedding(self, params: Params, token_embedding,
                          token_mask, pad_mask,
                          initial_patch_embeddings: Optional[torch.Tensor],
                          goal_images: Optional[torch.Tensor] = None,
                          goal_pad_mask: Optional[torch.Tensor] = None,
                          draws: Optional[Draws] = None):
        """(B, layer_token_num, context_dim) layer-token embeddings.
        goal_images (B, H, W, 3) uint8 and goal_pad_mask (B,) are the
        task's image_primary and its pad mask, with include_goal_image.
        draws: the training forward's dropout (None: no dropout)."""
        hk = self.hk
        batch, instr_len = token_embedding.shape[:2]
        dev = token_embedding.device
        tokens = layers.dense(token_embedding,
                              params["task_token_projection/kernel"],
                              params["task_token_projection/bias"])
        tokens = tokens + params["task_pos_embedding"]
        parts = [tokens]
        n_image = 0
        if self.use_initial_image:
            image = dropout(initial_patch_embeddings,
                            hk.get("image_dropout", 0.0), draws,
                            "image_dropout")
            if not hk.get("use_all_image_tokens", False):
                image = image[:, :1]
            image = layers.dense(image,
                                 params["initial_image_projection/kernel"],
                                 params["initial_image_projection/bias"])
            parts.append(image + params["initial_image_pos_embedding"])
            n_image = image.shape[1]
        n_goal = 0
        if self.include_goal_image:
            if goal_images is None or goal_pad_mask is None:
                raise ValueError("include_goal_image: pass the task's "
                                 "image_primary and its pad mask")
            goal = GOAL_STEM(params, GOAL_PREFIX, goal_images)
            goal = layers.dense(goal,
                                params["goal_image_token_projection/kernel"],
                                params["goal_image_token_projection/bias"])
            parts.append(goal + params["goal_image_pos_embedding"])
            n_goal = goal.shape[1]
        n_layer = self.layer_token_num
        parts.append(tokens.new_zeros(batch, n_layer, self.context_dim)
                     + params["layer_pos_embedding"])
        context = torch.cat(parts, dim=1)
        ctx_len = context.shape[1]

        def rows(cols):
            return cols[:, None, None, :].expand(batch, 1, ctx_len,
                                                 cols.shape[-1])

        if hk["attend_to_padding"]:
            instr = torch.ones((batch, instr_len), dtype=torch.bool,
                               device=dev)
        else:
            instr = token_mask.bool()
        instr = rows(instr) & pad_mask.bool()[:, None, None, None]
        masks = [instr]
        if n_image:
            masks.append(torch.ones((batch, 1, ctx_len, n_image),
                                    dtype=torch.bool, device=dev))
        if n_goal:
            masks.append(goal_pad_mask.bool()[:, None, None, None].expand(
                batch, 1, ctx_len, n_goal))
        # "full": one layer token whatever the block count, attended freely
        token_mask = ((True,) if self.strategy == "full"
                      else self.plan.layer_token_mask)
        layer = rows(torch.tensor(token_mask, device=dev)
                     .expand(batch, n_layer)).clone()
        if not hk["task_attend_to_layer"]:
            layer[:, :, :-n_layer, :] = False
        masks.append(layer)
        ce = hk["context_encoder_kwargs"]
        out = transformer(params, "context_encoder", context,
                          torch.cat(masks, dim=-1), ce["num_layers"],
                          ce["num_attention_heads"], self.ce_dropout,
                          self.ce_attention_dropout,
                          ce.get("add_position_embedding", False), draws)
        emb = out[:, -n_layer:]
        if hk.get("scale_context_embedding", False):
            emb = emb / math.sqrt(self.context_dim)
        return dropout(emb, hk.get("embedding_dropout_rate", 0.0), draws,
                       "embedding_dropout")

    def task_context(self, params: Params, task: dict, token_embedding,
                     initial_patch_embeddings=None,
                     draws: Optional[Draws] = None):
        """context_embedding of a batch's task dict (language_instruction
        attention_mask, pad_mask_dict, and with include_goal_image the goal
        frames image_primary) with the instruction's token_embedding."""
        goal = goal_mask = None
        if self.include_goal_image:
            goal = task["image_primary"]
            goal_mask = task["pad_mask_dict"]["image_primary"]
        return self.context_embedding(
            params, token_embedding.float(),
            task["language_instruction"]["attention_mask"],
            task["pad_mask_dict"]["language_instruction"],
            None if initial_patch_embeddings is None
            else initial_patch_embeddings.float(), goal, goal_mask, draws)

    def generate(self, params: Params, context_embedding,
                 draws: Optional[Draws] = None, fanout=None) -> Params:
        """Base-net params: generated blocks (B, *shape), shared blocks
        (*shape) without the batch dim. draws: the training forward's
        final dropout ("block" only, as in the JAX package). fanout(x,
        name, kernel): x @ kernel of each output-head kernel, one head at
        a time (a mesh's split matmul, parallel/sharded.py::
        ShardLayout.fanout); None multiplies each group's heads as one
        concatenated kernel."""
        plan = self.plan
        batch = context_embedding.shape[0]
        out = {}
        def unpack(flat, names):
            # torch.split, not one slice a block: the backward of a slice
            # writes a zero tensor of the whole output, so slicing n blocks
            # costs n passes over it in the backward, a split one
            parts = torch.split(flat, [plan.dim(n) for n in names], dim=1)
            return {name: part.reshape(batch, *plan.param_shape[name])
                    for name, part in zip(names, parts)}

        if self.strategy == "full":
            x, bias = context_embedding[:, 0], params.get("output_head/bias")
            if fanout is None:
                flat = layers.dense(x, params["output_head/kernel"], bias)
            else:
                flat = fanout(x, "output_head/kernel",
                              params["output_head/kernel"])
                flat = flat if bias is None else flat + bias
            out.update({name: value for name, value in unpack(
                flat, plan.names).items() if plan.generation_flag[name]})
        final_rate = self.hk.get("final_dropout_rate")
        for i, (token, names) in enumerate(self.packed_groups):
            heads = [plan.head_name(n) for n in names]
            if fanout is None:
                kernel = torch.cat([params[f"output_head_{h}/kernel"]
                                    for h in heads], dim=1)
                packed = context_embedding[:, token] @ kernel
            else:
                packed = torch.cat([
                    fanout(context_embedding[:, token],
                           f"output_head_{h}/kernel",
                           params[f"output_head_{h}/kernel"])
                    for h in heads], dim=1)
            if self.output_head_bias:
                packed = packed + torch.cat(
                    [params[f"output_head_{h}/bias"] for h in heads])
            packed = dropout(packed, final_rate, draws, f"final_dropout/{i}")
            out.update(unpack(packed, names))
        for name in plan.names:
            if not plan.generation_flag[name]:
                out[name] = params[WeightPlan.flat_name(name)].reshape(
                    plan.param_shape[name])
        return out


def per_sample_view(plan: WeightPlan, base_params: Params) -> Params:
    """Base-net params from `HyperNetwork.generate` in the layout the base
    net's ops broadcast over: a generated kernel stays (B, *shape), so
    `x @ W` is a batched matmul; a per-sample shape with a leading 1 (the
    position table) drops it, (B, n, d); any other generated block, a bias
    or a scale, gets a singleton after the sample axis, (B, 1, *shape),
    so that it broadcasts against (B, tokens, d). Shared blocks are
    unchanged."""
    out = {}
    for name, value in base_params.items():
        shape = plan.param_shape[name]
        if not plan.generation_flag[name] or name.endswith("/kernel"):
            out[name] = value
        elif len(shape) > 1 and shape[0] == 1:
            out[name] = value.squeeze(1)
        else:
            out[name] = value.unsqueeze(1)
    return out
