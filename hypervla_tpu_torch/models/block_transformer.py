"""The group-structured transformer of the Octo topology (counterpart of
hypervla_tpu/models/block_transformer.py).

Token groups declare when they attend to each other: prefix groups (the
task tokens) sit at the start of the sequence, timestep groups (the
observation and readout tokens) repeat at each step of the window. The
BlockTransformer lays them out as [prefix..., step 0 groups..., step 1
groups..., ...], builds the rule mask (one block per pair of segments, as
the JAX package fills it) AND the key padding mask, runs the transformer
(models/transformer.py) over the sequence and hands each group its own
output tokens back.

`use_correct_attention` is a field the JAX module takes and never reads:
the masks are the same either way, here too.
"""
import dataclasses
import logging
from enum import Enum
from fnmatch import fnmatch
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from hypervla_tpu_torch.models.draws import Draws
from hypervla_tpu_torch.models.token_group import TokenGroup
from hypervla_tpu_torch.models.transformer import (
    transformer,
    transformer_specs,
)


class AttentionRule(Enum):
    """When a group attends to another group."""

    NEVER = "never"
    CAUSAL = "other.timestep <= self.timestep"
    CURRENT = "other.timestep == self.timestep"
    STRICT_PAST = "other.timestep < self.timestep"
    ALL = "all"  # breaks causal structure; use with care


@dataclasses.dataclass
class PrefixGroup(TokenGroup):
    """Tokens at the start of the sequence: tokens (batch, n_tokens, d),
    mask (batch, n_tokens)."""

    name: str = ""
    attention_rules: Mapping[str, AttentionRule] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self):
        assert self.tokens.dim() == 3, (
            "PrefixGroup tokens must be (batch, n_tokens, d)")
        assert self.mask.dim() == 2, (
            "PrefixGroup mask must be (batch, n_tokens)")


@dataclasses.dataclass
class TimestepGroup(TokenGroup):
    """Tokens repeated a timestep: tokens (batch, horizon, n_tokens, d),
    mask (batch, horizon, n_tokens)."""

    name: str = ""
    attention_rules: Mapping[str, AttentionRule] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self):
        assert self.tokens.dim() == 4, (
            "TimestepGroup tokens must be (batch, horizon, n_tokens, d)")
        assert self.mask.dim() == 3, (
            "TimestepGroup mask must be (batch, horizon, n_tokens)")


def find_match(pattern_dict: Dict[str, Any], name: str, default: Any) -> Any:
    for pattern, value in pattern_dict.items():
        if fnmatch(name, pattern):
            return value
    return default


_RULE_PREDICATES = {
    AttentionRule.CAUSAL: lambda self_t, other_t: other_t <= self_t,
    AttentionRule.CURRENT: lambda self_t, other_t: other_t == self_t,
    AttentionRule.STRICT_PAST: lambda self_t, other_t: other_t < self_t,
    AttentionRule.ALL: lambda self_t, other_t: True,
    AttentionRule.NEVER: lambda self_t, other_t: False,
}


def _rule_allows(rule: AttentionRule, self_t: int, other_t: int) -> bool:
    try:
        return _RULE_PREDICATES[rule](self_t, other_t)
    except KeyError:
        raise ValueError(f"Invalid attention rule: {rule}") from None


class BlockTransformer:
    """The transformer over assembled prefix and timestep groups. Its
    params live under `<prefix>/Transformer_0` (the JAX module's auto
    name)."""

    def __init__(self, transformer_kwargs: Dict, enforce_causal: bool = True,
                 use_correct_attention: bool = False):
        self.transformer_kwargs = dict(transformer_kwargs)
        self.enforce_causal = enforce_causal
        self.use_correct_attention = use_correct_attention
        # rule masks on their devices, by the groups' layout
        self._rules = {}

    def __call__(self, params, prefix: str,
                 prefix_groups: Sequence[PrefixGroup],
                 timestep_groups: Sequence[TimestepGroup],
                 draws: Optional[Draws] = None, verbose: bool = False
                 ) -> Tuple[List[PrefixGroup], List[TimestepGroup]]:
        if verbose:
            self.pretty_print_attention_mask(prefix_groups, timestep_groups)
        horizon = timestep_groups[0].tokens.shape[1]
        assert all(g.tokens.shape[1] == horizon for g in timestep_groups)
        token_dim = timestep_groups[0].tokens.shape[-1]
        assert all(g.tokens.shape[-1] == token_dim
                   for g in list(prefix_groups) + list(timestep_groups))
        tokens = self.assemble_input_tokens(prefix_groups, timestep_groups)
        mask = self.generate_attention_mask(prefix_groups, timestep_groups)
        kw = self.transformer_kwargs
        output = transformer(
            params, f"{prefix}/Transformer_0", tokens, mask,
            kw["num_layers"], kw["num_attention_heads"],
            kw.get("dropout_rate", 0.1), kw.get("attention_dropout_rate", 0.1),
            kw.get("add_position_embedding", False), draws,
            learnable_norm=kw.get("learnable_norm", True),
            use_differential_transformer=kw.get(
                "use_differential_transformer", False))
        return self.split_output_tokens(output, prefix_groups,
                                        timestep_groups)

    def specs(self, prefix: str, token_dim: int, sequence_length: int = 0):
        """The transformer's params; sequence_length sizes the position
        table of add_position_embedding."""
        kw = self.transformer_kwargs
        return transformer_specs(
            f"{prefix}/Transformer_0", token_dim, kw["num_layers"],
            kw["mlp_dim"], kw["num_attention_heads"],
            sequence_length if kw.get("add_position_embedding") else 0,
            learnable_norm=kw.get("learnable_norm", True),
            use_differential_transformer=kw.get(
                "use_differential_transformer", False))

    def assemble_input_tokens(self, prefix_groups, timestep_groups):
        """The timestep groups concatenated a step, the window folded into
        the sequence, the prefix tokens first."""
        batch, _, _, width = timestep_groups[0].tokens.shape
        ref = timestep_groups[0].tokens
        prefix = (torch.cat([g.tokens for g in prefix_groups], dim=1)
                  if prefix_groups else
                  torch.zeros((batch, 0, width), dtype=torch.float32,
                              device=ref.device))
        per_step = torch.cat([g.tokens for g in timestep_groups], dim=2)
        return torch.cat([prefix, per_step.reshape(batch, -1, width)], dim=1)

    def split_output_tokens(self, output_tokens, prefix_groups,
                            timestep_groups):
        """assemble_input_tokens' inverse: each group its output tokens."""
        horizon = timestep_groups[0].tokens.shape[1]
        prefix_widths = [g.tokens.shape[1] for g in prefix_groups]
        n_prefix = sum(prefix_widths)
        head, tail = output_tokens[:, :n_prefix], output_tokens[:, n_prefix:]
        prefix_out = [g.replace(tokens=part) for g, part in zip(
            prefix_groups, torch.split(head, prefix_widths, dim=1))]
        unfolded = tail.reshape(tail.shape[0], horizon, -1, tail.shape[-1])
        ts_widths = [g.tokens.shape[2] for g in timestep_groups]
        timestep_out = [g.replace(tokens=part) for g, part in zip(
            timestep_groups, torch.split(unfolded, ts_widths, dim=2))]
        return prefix_out, timestep_out

    def rule_mask(self, prefix_groups, timestep_groups) -> np.ndarray:
        """The (total, total) boolean rule mask: a block of True where the
        row segment's rule toward the column segment's group allows its
        timestep."""
        horizon = timestep_groups[0].tokens.shape[1]
        segments = [(g, -1, g.tokens.shape[1]) for g in prefix_groups]
        for t in range(horizon):
            segments.extend((g, t, g.tokens.shape[2])
                            for g in timestep_groups)
        total = sum(n for _, _, n in segments)
        mask = np.zeros((total, total), dtype=bool)
        offsets = np.concatenate([[0], np.cumsum([n for _, _, n in
                                                  segments])])
        for i, (gi, ti, ni) in enumerate(segments):
            for j, (gj, tj, nj) in enumerate(segments):
                rule = find_match(gi.attention_rules, gj.name,
                                  AttentionRule.NEVER)
                if _rule_allows(rule, ti, tj):
                    mask[offsets[i]:offsets[i] + ni,
                         offsets[j]:offsets[j] + nj] = True
        return mask

    def generate_attention_mask(self, prefix_groups, timestep_groups):
        """The rule mask AND the padding mask, (batch, 1, total, total)."""
        if self.enforce_causal:
            self.verify_causality(prefix_groups, timestep_groups)
        pad = self.generate_pad_attention_mask(prefix_groups,
                                               timestep_groups)
        key = (str(pad.device),) + tuple(
            (g.name, tuple(g.tokens.shape[1:-1]),
             tuple((k, v.value) for k, v in g.attention_rules.items()))
            for g in list(prefix_groups) + list(timestep_groups))
        if key not in self._rules:
            self._rules[key] = torch.from_numpy(self.rule_mask(
                prefix_groups, timestep_groups)).to(pad.device)
        return torch.logical_and(self._rules[key], pad)

    def generate_pad_attention_mask(self, prefix_groups, timestep_groups):
        """Key-side padding: (batch, 1, L, L), a padded token's column
        False in every row."""
        batch = timestep_groups[0].tokens.shape[0]
        parts = []
        if prefix_groups:
            parts.append(torch.cat([g.mask.bool() for g in prefix_groups],
                                   dim=1))
        parts.append(torch.cat([g.mask.bool() for g in timestep_groups],
                               dim=2).reshape(batch, -1))
        key_valid = torch.cat(parts, dim=1)
        length = key_valid.shape[1]
        return key_valid[:, None, None, :].expand(batch, 1, length, length)

    def verify_causality(self, prefix_groups, timestep_groups):
        """No prefix group attends to a timestep group (by exact name), and
        no rule is ALL."""
        everyone = list(prefix_groups) + list(timestep_groups)
        violations = [
            (p.name, t.name) for p in prefix_groups for t in timestep_groups
            if p.attention_rules.get(t.name, AttentionRule.NEVER)
            != AttentionRule.NEVER]
        assert not violations, (
            f"Causality broken! Prefix groups attend to timestep groups: "
            f"{violations}")
        for group in everyone:
            for other in everyone:
                rule = find_match(group.attention_rules, other.name,
                                  AttentionRule.NEVER)
                assert rule != AttentionRule.ALL, (
                    "Causality broken! AttentionRule.ALL attends to future "
                    "timesteps too.")

    def pretty_print_attention_mask(self, prefix_groups, timestep_groups):
        for group in prefix_groups:
            logging.warning("PrefixGroup(name=%s, shape=%s, attends_to=%s)",
                            group.name, tuple(group.tokens.shape),
                            dict(group.attention_rules))
        for group in timestep_groups:
            logging.warning("TimestepGroup(name=%s, shape=%s, attends_to=%s)",
                            group.name, tuple(group.tokens.shape),
                            dict(group.attention_rules))
