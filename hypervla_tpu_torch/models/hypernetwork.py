"""HyperNetwork: task -> base-network weights (counterpart of
hypervla_tpu/models/hypernetwork.py).

The context encoder runs over [task tokens | initial-image CLS token |
layer tokens] under the JAX package's attention mask; the layer-token
outputs, optionally scaled by 1/sqrt(context_dim), feed the fan-out. Two
generation strategies:

  * "block": one layer token per context-token group of the plan; every
    generated block keeps its own output head (kernel, bias); the heads
    sharing a context token are concatenated into one
    [context_dim, sum(dims)] matrix and applied as one matmul per group;
  * "full": one layer token and one output head (`output_head`) over the
    flat vector of every base-net param, shared blocks included, walked in
    the plan's block order (the JAX package's block_entries order).

Shared blocks (the DINOv2 trunk) are flat params copied into the base-net
tree unchanged.

In training the hypernetwork runs over the whole batch; `per_sample_view`
lays each sample's generated blocks out so that the base net's ops
broadcast over the sample axis (the JAX package vmaps a per-sample loss).

Param names follow the JAX package: task_token_projection,
task_pos_embedding, initial_image_projection, initial_image_pos_embedding,
layer_pos_embedding, context_encoder/..., output_head_<block>/{kernel,bias}
and <block> for each shared block (block = its path joined by "_"); under
"full" one output_head/{kernel,bias}.
"""
import math
from typing import Dict, Optional, Tuple

import torch

from hypervla_tpu_torch.configs import refuse_dropout
from hypervla_tpu_torch.models import layers
from hypervla_tpu_torch.models.transformer import transformer, transformer_specs
from hypervla_tpu_torch.models.weight_plan import WeightPlan

Params = Dict[str, torch.Tensor]


class HyperNetwork:
    def __init__(self, plan: WeightPlan, hypernet_kwargs: dict):
        hk = hypernet_kwargs
        self.strategy = hk.get("generation_strategy", "full")
        if self.strategy not in ("block", "full"):
            raise ValueError(
                f"unknown generation_strategy {self.strategy}")
        unsupported = {
            "include_goal_image": hk.get("include_goal_image", False),
            "output_head_bias": not hk.get("output_head_bias", True),
            "context_encoder_kwargs.add_position_embedding":
                hk["context_encoder_kwargs"].get("add_position_embedding",
                                                 False),
        }
        for name, bad in unsupported.items():
            if bad:
                raise NotImplementedError(
                    f"hypernet_kwargs {name} is not ported yet (ROADMAP.md "
                    "A8, the rest of the train step)")
        refuse_dropout("hypernet_kwargs", hk)
        refuse_dropout("hypernet_kwargs context_encoder_kwargs",
                       hk["context_encoder_kwargs"])
        self.plan = plan
        self.hk = hk
        self.context_dim = hk["context_embedding_dim"]
        self.layer_token_num = (plan.block_num if self.strategy == "block"
                                else 1)
        self.use_initial_image = hk.get("use_initial_image", False)
        groups: Dict[int, list] = {}
        for name in plan.names:
            if plan.generation_flag[name] and self.strategy == "block":
                groups.setdefault(plan.token_index[name], []).append(name)
        self.packed_groups = tuple(sorted(groups.items()))

    def specs(self, instr_len: int, token_dim: int, image_tokens: int,
              patch_dim: int) -> Dict[str, Tuple[tuple, layers.Init]]:
        """Param shapes and initializers (output-head kernels start at zero;
        biases and shared blocks are overwritten by the bias-init protocol
        in HyperVLA.from_config)."""
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
        if self.use_initial_image:
            specs.update({
                "initial_image_projection/kernel": ((patch_dim, c),
                                                    layers.lecun_normal),
                "initial_image_projection/bias": ((c,), layers.zeros),
                "initial_image_pos_embedding": ((1, image_tokens, c),
                                                layers.normal(0.02)),
            })
        specs.update(transformer_specs(
            "context_encoder", c, ce["num_layers"], ce["mlp_dim"],
            ce["num_attention_heads"]))
        if self.strategy == "full":
            total = self.plan.total_param_num
            specs["output_head/kernel"] = ((c, total), layers.zeros)
            specs["output_head/bias"] = ((total,), layers.zeros)
        for name in self.plan.names:
            flat = WeightPlan.flat_name(name)
            dim = self.plan.output_head_info[flat]["output_dim"]
            if self.strategy == "full" and self.plan.generation_flag[name]:
                continue
            if self.plan.generation_flag[name]:
                specs[f"output_head_{flat}/kernel"] = ((c, dim), layers.zeros)
                specs[f"output_head_{flat}/bias"] = ((dim,), layers.zeros)
            else:
                specs[flat] = ((dim,), layers.truncated_normal(0.02))
        return specs

    def context_embedding(self, params: Params, token_embedding,
                          token_mask, pad_mask,
                          initial_patch_embeddings: Optional[torch.Tensor]):
        """(B, layer_token_num, context_dim) layer-token embeddings."""
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
            image = initial_patch_embeddings
            if not hk.get("use_all_image_tokens", False):
                image = image[:, :1]
            image = layers.dense(image,
                                 params["initial_image_projection/kernel"],
                                 params["initial_image_projection/bias"])
            parts.append(image + params["initial_image_pos_embedding"])
            n_image = image.shape[1]
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
                          ce["num_attention_heads"])
        emb = out[:, -n_layer:]
        if hk.get("scale_context_embedding", False):
            emb = emb / math.sqrt(self.context_dim)
        return emb

    def generate(self, params: Params, context_embedding) -> Params:
        """Base-net params: generated blocks (B, *shape), shared blocks
        (*shape) without the batch dim."""
        plan = self.plan
        batch = context_embedding.shape[0]
        out = {}
        if self.strategy == "full":
            flat = layers.dense(context_embedding[:, 0],
                                params["output_head/kernel"],
                                params["output_head/bias"])
            offset = 0
            for name in plan.names:
                dim = plan.output_head_info[WeightPlan.flat_name(name)][
                    "output_dim"]
                if plan.generation_flag[name]:
                    out[name] = flat[:, offset:offset + dim].reshape(
                        batch, *plan.param_shape[name])
                offset += dim
        for token, names in self.packed_groups:
            flats = [WeightPlan.flat_name(n) for n in names]
            kernel = torch.cat([params[f"output_head_{f}/kernel"]
                                for f in flats], dim=1)
            bias = torch.cat([params[f"output_head_{f}/bias"]
                              for f in flats])
            packed = context_embedding[:, token] @ kernel + bias
            offset = 0
            for name, flat in zip(names, flats):
                dim = plan.output_head_info[flat]["output_dim"]
                out[name] = packed[:, offset:offset + dim].reshape(
                    batch, *plan.param_shape[name])
                offset += dim
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
