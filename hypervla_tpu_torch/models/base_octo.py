"""The Octo transformer and its module with heads (counterpart of
hypervla_tpu/models/base_octo.py).

The blockwise-causal sequence is [task tokens, obs t=0 + readout t=0, obs
t=1 + readout t=1, ...]. Every token source goes through `_embed_group`:
a Dense projection to the model width (`<group>_projection`) plus the
group's learned position table (`<group>_pos_embedding`; a timestep
group's table covers max_horizon steps and is cut to the window). The
task's language tokens are precomputed (frozen) T5 token embeddings;
`use_pretrained_image_tokenizer` takes precomputed patch tokens
(observations["image_patches"]) for the image tokenizers. With
repeat_task_tokens the task tokens also appear at every timestep, as an
"obs_task_language" group. Readout groups are pure position tables.

Params are one flat dict under the JAX module paths: "octo_transformer/
..." (its tokenizers under observation_tokenizers_<name>, its transformer
under BlockTransformer_0) and "heads_<name>/..." for each head, which the
heads read as "action_head/..." (a view of the same tensors).

A generated base net (HyperVLA with model_type "octo") runs this
transformer on per-sample params (models/hypernetwork.py::per_sample_view:
kernels (B, in, out), biases (B, 1, out), position tables (B, ...)), over
a window of one frame, as the JAX train step's per-sample vmap does.
"""
import logging
from typing import Dict, Optional, Sequence

import torch

from hypervla_tpu_torch.models import layers
from hypervla_tpu_torch.models.block_transformer import (
    AttentionRule,
    BlockTransformer,
    PrefixGroup,
    TimestepGroup,
)
from hypervla_tpu_torch.models.draws import Draws
from hypervla_tpu_torch.models.token_group import TokenGroup
from hypervla_tpu_torch.utils.spec import ModuleSpec

PREFIX = "octo_transformer"
HEAD_PREFIX = "action_head/"

# what each group kind is allowed to attend to
_RULES_TASK = {"task_*": AttentionRule.CAUSAL}
_RULES_OBS = {"task_*": AttentionRule.CAUSAL, "obs_*": AttentionRule.CAUSAL}


def _readout_rules(group_name):
    return {**_RULES_OBS, group_name: AttentionRule.CAUSAL}


def _dense(x, kernel, bias):
    """A Dense on tokens (..., in): a per-sample kernel (B, in, out) on
    (B, T, n, in) runs over the tokens flattened to (B, T * n, in)."""
    if kernel.dim() == 3 and x.dim() > 3:
        y = x.flatten(1, -2) @ kernel + bias
        return y.reshape(*x.shape[:-1], y.shape[-1])
    return layers.dense(x, kernel, bias)


def _shape(x):
    return tuple(getattr(x, "shape", ()))


class OctoTransformer:
    def __init__(self, observation_tokenizers: Dict, readouts: Dict[str, int],
                 transformer_kwargs: Dict, token_embedding_size: int,
                 max_horizon: int, repeat_task_tokens: bool,
                 use_correct_attention: bool = False,
                 use_pretrained_image_tokenizer: bool = False,
                 prefix: str = PREFIX):
        """prefix: where its params live ("encoder" in a generated base
        net)."""
        self.prefix = prefix
        self.observation_tokenizers = observation_tokenizers
        self.readouts = readouts
        self.transformer_kwargs = transformer_kwargs
        self.token_embedding_size = token_embedding_size
        self.max_horizon = max_horizon
        self.repeat_task_tokens = repeat_task_tokens
        self.use_correct_attention = use_correct_attention
        self.use_pretrained_image_tokenizer = use_pretrained_image_tokenizer
        self.block_transformer = BlockTransformer(
            transformer_kwargs, use_correct_attention=use_correct_attention)

    # ------------------------------ groups ------------------------------

    def _pos_embedding(self, params, name: str, tokens):
        """The group's position table, broadcast to its tokens; a
        timestep group's cut to the window."""
        if tokens.dim() not in (3, 4):
            raise ValueError(f"Invalid tokens shape: {tuple(tokens.shape)}")
        pos = params[f"{self.prefix}/{name}_pos_embedding"]
        if tokens.dim() == 4:
            pos = pos[:, :tokens.shape[1]]
        return pos.expand(tokens.shape)

    def _embed_group(self, params, group_name, raw_tokens,
                     stop_gradient=False):
        if stop_gradient:
            raw_tokens = raw_tokens.detach()
        p = f"{self.prefix}/{group_name}_projection"
        tokens = _dense(raw_tokens.float(), params[f"{p}/kernel"],
                        params[f"{p}/bias"])
        return tokens + self._pos_embedding(params, group_name, tokens)

    def _language_prefix(self, params, tasks) -> PrefixGroup:
        tokens = self._embed_group(
            params, "task_language",
            tasks["language_instruction"]["token_embedding"],
            stop_gradient=True)
        mask = tasks["pad_mask_dict"]["language_instruction"][:, None]
        return PrefixGroup(tokens=tokens,
                           mask=mask.bool().expand(tokens.shape[:-1]),
                           name="task_language", attention_rules=_RULES_TASK)

    def _observation_groups(self, params, observations, tasks,
                            timestep_pad_mask, draws):
        groups = []

        def add(group_name, tokens, token_mask):
            groups.append(TimestepGroup(
                tokens=tokens,
                mask=torch.logical_and(timestep_pad_mask[:, :, None].bool(),
                                       token_mask.bool()),
                name=group_name, attention_rules=_RULES_OBS))

        if self.use_pretrained_image_tokenizer:
            patches = observations["image_patches"]
            add("obs_primary",
                self._embed_group(params, "obs_primary", patches["token"],
                                  stop_gradient=True),
                patches["mask"])
            return groups
        for name, tokenizer in self.observation_tokenizers.items():
            group_name = f"obs_{name}"
            out = tokenizer(params,
                            f"{self.prefix}/observation_tokenizers_{name}",
                            observations, tasks, draws)
            if out is None:
                logging.warning(
                    f"Skipping observation tokenizer: {group_name}")
                continue
            add(group_name, self._embed_group(params, group_name, out.tokens),
                out.mask)
        return groups

    def _readout_group(self, params, readout_name, batch_size, horizon,
                       device):
        group_name = f"readout_{readout_name}"
        width = self.readouts[readout_name]
        zeros = torch.zeros((batch_size, horizon, width,
                             self.token_embedding_size), device=device)
        return TimestepGroup(
            tokens=zeros + self._pos_embedding(params, group_name, zeros),
            mask=torch.ones((batch_size, horizon, width), dtype=torch.bool,
                            device=device),
            name=group_name, attention_rules=_readout_rules(group_name))

    def __call__(self, params, observations, tasks, timestep_pad_mask,
                 readouts: Optional[Sequence[str]] = None,
                 draws: Optional[Draws] = None, verbose: bool = False
                 ) -> Dict[str, TokenGroup]:
        """-> {group name: TokenGroup of its output tokens}, and "task"
        (the prefix groups') and "obs" (the observation groups'). draws:
        the training forward's dropout (the JAX module's train=True)."""
        readouts = list(self.readouts) if readouts is None else readouts
        assert set(readouts).issubset(self.readouts.keys()), (
            "readouts must be specified in the model config")
        assert not self.transformer_kwargs.get(
            "add_position_embedding", False), (
            "Positional embeddings are already added to the tokens")
        first = _first_leaf(observations)
        batch_size, horizon = first.shape[:2]
        assert horizon <= self.max_horizon, "horizon must be <= max_horizon"

        prefix_groups = [self._language_prefix(params, tasks)]
        timestep_groups = self._observation_groups(
            params, observations, tasks, timestep_pad_mask, draws)
        if self.repeat_task_tokens:
            # the task tokens at every timestep, so that later timesteps
            # attend to them under the blockwise-causal mask
            ws = timestep_groups[0].tokens.shape[1]
            for task_group in prefix_groups:
                timestep_groups.append(TimestepGroup(
                    tokens=task_group.tokens[:, None].expand(
                        -1, ws, -1, -1),
                    mask=task_group.mask[:, None].expand(-1, ws, -1),
                    name=f"obs_{task_group.name}",
                    attention_rules=_RULES_OBS))
        device = timestep_groups[0].tokens.device
        timestep_groups += [self._readout_group(params, r, batch_size,
                                                horizon, device)
                            for r in readouts]
        prefix_out, timestep_out = self.block_transformer(
            params, f"{self.prefix}/BlockTransformer_0", prefix_groups,
            timestep_groups, draws, verbose)

        outputs = {g.name: TokenGroup(g.tokens, g.mask) for g in prefix_out}
        outputs.update({g.name: TokenGroup(g.tokens, g.mask)
                        for g in timestep_out})
        if prefix_out:
            outputs["task"] = TokenGroup.concatenate(
                [TokenGroup(g.tokens, g.mask) for g in prefix_out])
        outputs["obs"] = TokenGroup.concatenate(
            [TokenGroup(g.tokens, g.mask) for g in timestep_out
             if g.name.startswith("obs_")], axis=-2)
        return outputs

    # ------------------------------ specs ------------------------------

    def specs(self, observations, tasks):
        """Param shapes and initializers over an example batch (numpy or
        torch leaves)."""
        d, top = self.token_embedding_size, self.prefix
        specs = {}

        def group(name, in_dim, pos_shape):
            specs[f"{top}/{name}_pos_embedding"] = (pos_shape,
                                                    layers.normal(0.02))
            specs[f"{top}/{name}_projection/bias"] = ((d,), layers.zeros)
            specs[f"{top}/{name}_projection/kernel"] = (
                (in_dim, d), layers.lecun_normal)

        lang = _shape(tasks["language_instruction"]["token_embedding"])
        group("task_language", lang[-1], (1, lang[-2], d))
        n_tokens = {}
        if self.use_pretrained_image_tokenizer:
            tok = _shape(observations["image_patches"]["token"])
            group("obs_primary", tok[-1], (1, self.max_horizon, tok[-2], d))
        else:
            for name, tokenizer in self.observation_tokenizers.items():
                prefix = f"{top}/observation_tokenizers_{name}"
                specs.update(tokenizer.specs(prefix, observations, tasks))
                shape = _token_shape(tokenizer, observations, tasks)
                if shape is None:
                    continue
                n_tokens[name] = shape
                group(f"obs_{name}", shape[-1],
                      (1, self.max_horizon, shape[-2], d))
        for name, width in self.readouts.items():
            specs[f"{top}/readout_{name}_pos_embedding"] = (
                (1, self.max_horizon, width, d), layers.normal(0.02))
        specs.update(self.block_transformer.specs(
            f"{top}/BlockTransformer_0", d))
        return specs


def _first_leaf(tree):
    """The first leaf of nested dicts in jax's order (sorted keys)."""
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            leaf = _first_leaf(value)
            if leaf is not None:
                return leaf
        else:
            return value
    return None


def _token_shape(tokenizer, observations, tasks):
    """The (n_tokens, width) of a tokenizer's output on the example batch
    (None where it skips): the tokenizer run on zero inputs with zero
    params at its spec'd shapes."""
    from hypervla_tpu_torch.models.tokenizers import _shapes

    obs, tk = _shapes(observations), _shapes(tasks)
    specs = tokenizer.specs("t", obs, tk)
    zeros = {k: torch.zeros(shape) for k, (shape, _) in specs.items()}
    with torch.no_grad():
        out = tokenizer(zeros, "t", obs, tk)
    return None if out is None else tuple(out.tokens.shape[-2:])


class OctoModule:
    """OctoTransformer with its heads, each under "heads_<name>/"."""

    def __init__(self, octo_transformer: OctoTransformer, heads: Dict):
        self.octo_transformer = octo_transformer
        self.heads = heads

    @staticmethod
    def head_params(params, name: str):
        """The params of head `name` as the head reads them
        ("action_head/..."): the same tensors, renamed."""
        prefix = f"heads_{name}/"
        return {HEAD_PREFIX + k[len(prefix):]: v for k, v in params.items()
                if k.startswith(prefix)}

    def specs(self, observations, tasks):
        specs = self.octo_transformer.specs(observations, tasks)
        d = self.octo_transformer.token_embedding_size
        for name, head in self.heads.items():
            width = d
            if getattr(head, "flatten_tokens", False):
                key = head.readout_key
                width = d * self.octo_transformer.readouts[
                    key[len("readout_"):]]
            for k, v in head.specs(width).items():
                specs[f"heads_{name}/{k[len(HEAD_PREFIX):]}"] = v
        return specs

    @classmethod
    def create(cls, observation_tokenizers: Dict[str, ModuleSpec],
               heads: Dict[str, ModuleSpec], readouts: Dict[str, int],
               transformer_kwargs: Dict, token_embedding_size: int,
               max_horizon: int, repeat_task_tokens: bool = False,
               use_correct_attention: bool = False,
               task_tokenizers: Optional[Dict[str, ModuleSpec]] = None,
               use_pretrained_image_tokenizer: bool = False
               ) -> "OctoModule":
        def instantiate(specs):
            return {k: ModuleSpec.instantiate(spec)()
                    for k, spec in specs.items()}

        return cls(
            octo_transformer=OctoTransformer(
                observation_tokenizers=instantiate(observation_tokenizers),
                readouts=readouts,
                token_embedding_size=token_embedding_size,
                max_horizon=max_horizon,
                repeat_task_tokens=repeat_task_tokens,
                transformer_kwargs=transformer_kwargs,
                use_correct_attention=use_correct_attention,
                use_pretrained_image_tokenizer=(
                    use_pretrained_image_tokenizer)),
            heads=instantiate(heads))
