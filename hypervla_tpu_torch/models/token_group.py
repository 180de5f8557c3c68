"""TokenGroup: tokens with their mask (counterpart of
hypervla_tpu/models/token_group.py).

tokens (..., n_tokens, d); mask (..., n_tokens), boolean, True where the
token is valid (None reads as all valid).
"""
import dataclasses
from typing import Optional, Sequence

import torch


@dataclasses.dataclass
class TokenGroup:
    tokens: torch.Tensor
    mask: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, tokens, mask=None, **kwargs):
        if mask is None:
            mask = torch.ones(tokens.shape[:-1], dtype=torch.bool,
                              device=tokens.device)
        assert mask.dim() == tokens.dim() - 1, (
            "mask must have one fewer dim than tokens")
        return cls(tokens, mask, **kwargs)

    @classmethod
    def concatenate(cls, group_list: Sequence["TokenGroup"], axis: int = -2):
        data = torch.cat([t.tokens for t in group_list], dim=axis)
        mask = torch.cat([
            t.mask if t.mask is not None
            else torch.ones(t.tokens.shape[:-1], dtype=torch.bool,
                            device=t.tokens.device)
            for t in group_list], dim=axis + 1 if axis < 0 else axis)
        return cls(data, mask)

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def tokens_and_mask(x):
    """(tokens, mask) of a TokenGroup, (x, None) of a tensor."""
    if isinstance(x, TokenGroup):
        return x.tokens, x.mask
    return x, None
