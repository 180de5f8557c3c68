"""The tokenizers (counterpart of hypervla_tpu/models/tokenizers.py).

`BinTokenizer`, the discrete action head's: each value to one of n_bins
tokens, by bin edges spaced evenly on [low, high] ("uniform") or at
equal-mass quantiles of a standard normal ("normal").

The Octo topology's observation and task tokenizers, each called as
`tokenizer(params, prefix, observations, tasks, draws=None)` -> a
TokenGroup (None where the inputs it reads are missing), with
`specs(prefix, observations, tasks)` over an example batch (the params'
shapes follow the data): `ImageTokenizer` (matching image keys stacked on
the channel axis, goal images from the task too, through a patch encoder
of models/vit_encoders.py, FiLM-conditioned on task keys, optionally
compressed by a `TokenLearner`), `LanguageTokenizer` (precomputed token
embeddings, or input ids through its in-model T5 under `<prefix>/hf_model`)
and `LowdimObsTokenizer` (non-spatial observations, optionally discretized).

The edges are the JAX package's fp32 ones: jnp.linspace's formula
(start * (1 - step) + stop * step, step = iota / div, the last edge the
stop itself) in fp32, and for "normal" the standard normal's quantile
function of those points, here scipy's (float64, rounded to fp32).
"""
import logging
import re
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from hypervla_tpu_torch.models import layers
from hypervla_tpu_torch.models.encoders.pretrained import load_t5_weights
from hypervla_tpu_torch.models.encoders.t5 import t5_config, t5_encode, t5_specs
from hypervla_tpu_torch.models.token_group import TokenGroup
from hypervla_tpu_torch.models.transformer import map_head, map_head_specs
from hypervla_tpu_torch.utils.convert import subtree
from hypervla_tpu_torch.utils.spec import ModuleSpec

EPS = 1e-6


def linspace_fp32(start: float, stop: float, num: int) -> torch.Tensor:
    """jnp.linspace(start, stop, num) in fp32, by jax's own formula."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float32) / div
    start_t = torch.tensor(start, dtype=torch.float32)
    stop_t = torch.tensor(stop, dtype=torch.float32)
    out = start_t * (1 - step) + stop_t * step
    return torch.cat([out, stop_t[None]])


class BinTokenizer:
    def __init__(self, bin_type: str = "uniform", n_bins: int = 256,
                 low: float = -1.0, high: float = 1.0):
        self.bin_type = bin_type
        self.n_bins = n_bins
        self.low = low
        self.high = high
        if bin_type == "uniform":
            edges = linspace_fp32(low, high, n_bins + 1)
        elif bin_type == "normal":
            from scipy.stats import norm

            points = linspace_fp32(EPS, 1 - EPS, n_bins + 1).numpy()
            edges = torch.from_numpy(
                norm.ppf(points.astype(np.float64)).astype(np.float32))
        else:
            raise ValueError(f"Binning type {bin_type} not supported.")
        #: (n_bins + 1,) fp32 edges on the host; each call moves them to
        #: its input's device
        self.thresholds = edges
        self._on = {}

    def _edges(self, device) -> torch.Tensor:
        key = str(device)
        if key not in self._on:
            self._on[key] = self.thresholds.to(device)
        return self._on[key]

    def __call__(self, inputs) -> torch.Tensor:
        """Values -> int32 tokens: the interior edge search with
        side="right" (a value on an edge takes the bin above it), and a
        value outside [edges[0], edges[-1]) token 0; uniform bins clip to
        [low + EPS, high - EPS] first."""
        edges = self._edges(inputs.device)
        if self.bin_type == "uniform":
            inputs = torch.clamp(inputs, self.low + EPS, self.high - EPS)
        token = torch.searchsorted(edges[1:-1], inputs.contiguous(),
                                   right=True)
        in_range = (inputs >= edges[0]) & (inputs < edges[-1])
        return torch.where(in_range, token, 0).to(torch.int32)

    def decode(self, tokens) -> torch.Tensor:
        """Tokens -> the centres of their bins."""
        edges = self._edges(tokens.device)
        centers = (edges[1:] + edges[:-1]) / 2
        return centers[tokens.long()]


# ----------------------------- the Octo topology -----------------------------


def regex_match(regex_keys, x) -> bool:
    return any(re.match(pattern, x) for pattern in regex_keys)


def regex_filter(regex_keys, xs):
    return [x for x in xs if regex_match(regex_keys, x)]


def _gather_matching(mapping, keys, min_rank: Optional[int] = None):
    """mapping[key] for the keys, concatenated on the last axis; with
    min_rank, each must have at least that many dims."""
    parts = []
    for key in keys:
        if min_rank is not None:
            assert mapping[key].dim() >= min_rank, (
                f"{key}: expected rank >= {min_rank}, got "
                f"{tuple(mapping[key].shape)}")
        parts.append(mapping[key])
    return torch.cat(parts, dim=-1)


def _shapes(mapping):
    """A batch dict of arrays as a dict of zero tensors of their shapes
    and dtypes (what specs reads), nested dicts kept."""
    out = {}
    for k, v in mapping.items():
        if isinstance(v, dict):
            out[k] = _shapes(v)
        else:
            a = np.asarray(v)
            out[k] = torch.zeros(a.shape, dtype=torch.from_numpy(
                np.zeros((), a.dtype)).dtype) if a.dtype != object else v
    return out


def generate_proper_pad_mask(tokens, pad_mask_dict: Optional[Dict],
                             keys: Sequence[str]):
    """A token row is valid where any of its source keys is not padding;
    all valid (with a warning) where the masks are missing."""
    if pad_mask_dict is None:
        logging.warning("No pad_mask_dict found. Nothing will be masked.")
        return torch.ones(tokens.shape[:-1], dtype=torch.bool,
                          device=tokens.device)
    missing = [k for k in keys if k not in pad_mask_dict]
    if missing:
        logging.warning(f"pad_mask_dict missing keys {set(missing)}. "
                        "Nothing will be masked.")
        return torch.ones(tokens.shape[:-1], dtype=torch.bool,
                          device=tokens.device)
    valid = torch.stack([pad_mask_dict[k].bool() for k in keys],
                        dim=-1).any(-1)
    return valid[..., None].expand(tokens.shape[:-1])


class TokenLearner:
    """`num_tokens` learned readouts of a token sequence: MAP pooling
    (models/transformer.py::map_head) over the position-embedded,
    normalized inputs."""

    def __init__(self, num_tokens: int):
        self.num_tokens = num_tokens

    def __call__(self, params, prefix: str, inputs, draws=None):
        x = layers.layer_norm(inputs + params[f"{prefix}/pos_embed"],
                              params[f"{prefix}/LayerNorm_0/scale"],
                              params[f"{prefix}/LayerNorm_0/bias"])
        return map_head(params, f"{prefix}/MAPHead_0", x,
                        num_readouts=self.num_tokens, draws=draws)

    def specs(self, prefix: str, n_tokens: int, dim: int):
        specs = {f"{prefix}/pos_embed": ((n_tokens, dim), layers.normal(0.02)),
                 f"{prefix}/LayerNorm_0/bias": ((dim,), layers.zeros),
                 f"{prefix}/LayerNorm_0/scale": ((dim,), layers.ones)}
        specs.update(map_head_specs(f"{prefix}/MAPHead_0", dim,
                                    self.num_tokens))
        return specs


class ImageTokenizer:
    """Stacks the matching image observations (and goal images of the
    task) on the channel axis and runs the patch encoder over each frame;
    optionally FiLM-conditioned on task_film_keys and compressed by a
    TokenLearner. The encoder's params live under
    `<prefix>/<its class name>_0`, as flax names it."""

    def __init__(self, encoder: ModuleSpec,
                 obs_stack_keys: Sequence[str] = ("image_.*", "depth_.*"),
                 task_stack_keys: Sequence[str] = tuple(),
                 task_film_keys: Sequence[str] = tuple(),
                 use_token_learner: bool = False, num_tokens: int = 8,
                 proper_pad_mask: bool = True,
                 conditioning_type: str = "none"):
        self.encoder = ModuleSpec.instantiate(encoder)()
        self.encoder_name = f"{type(self.encoder).__name__}_0"
        self.obs_stack_keys = tuple(obs_stack_keys)
        self.task_stack_keys = tuple(task_stack_keys)
        self.task_film_keys = tuple(task_film_keys)
        self.use_token_learner = use_token_learner
        self.num_tokens = num_tokens
        self.proper_pad_mask = proper_pad_mask
        self.conditioning_type = conditioning_type
        self.token_learner = TokenLearner(num_tokens)

    def _stack_task_channels(self, enc_inputs, observations, tasks):
        """The goal images' channels (zeros where the task lacks them),
        repeated over the window."""
        tasks = dict(tasks)
        for k in regex_filter(self.task_stack_keys, observations.keys()):
            if k not in tasks:
                logging.info(f"No task inputs matching {k}; zero-padding.")
                tasks[k] = torch.zeros_like(observations[k][:, 0])
        matched = regex_filter(self.task_stack_keys, sorted(tasks.keys()))
        if not matched:
            raise ValueError(f"No task inputs matching "
                             f"{self.task_stack_keys} were found.")
        goal = _gather_matching(tasks, matched, min_rank=4)
        goal = goal[:, None].expand(-1, enc_inputs.shape[1],
                                    *goal.shape[1:])
        return torch.cat([enc_inputs, goal], dim=-1), tasks

    def _inputs(self, observations, tasks):
        """(frames (B * T, H, W, C), cond (B * T, D) or None, B, T, the
        matched observation keys), or None without matching images."""
        matched = regex_filter(self.obs_stack_keys,
                               sorted(observations.keys()))
        if not matched:
            logging.info(f"No image inputs matching {self.obs_stack_keys} "
                         "found; skipping.")
            assert self.proper_pad_mask, (
                "Cannot skip unless using proper_pad_mask.")
            return None
        enc_inputs = _gather_matching(observations, matched, min_rank=4)
        if self.task_stack_keys:
            enc_inputs, tasks = self._stack_task_channels(
                enc_inputs, observations, tasks)
        b, t = enc_inputs.shape[:2]
        frames = enc_inputs.reshape(b * t, *enc_inputs.shape[2:])
        cond = None
        if self.task_film_keys:
            film = _gather_matching(tasks, self.task_film_keys)
            cond = film[:, None].expand(b, t, film.shape[-1]).reshape(b * t,
                                                                      -1)
        return frames, cond, b, t, matched

    def __call__(self, params, prefix: str, observations, tasks=None,
                 draws=None):
        inputs = self._inputs(observations, tasks)
        if inputs is None:
            return None
        frames, cond, b, t, matched = inputs
        kwargs = {} if cond is None else {"cond_var": cond}
        tokens = self.encoder(params, f"{prefix}/{self.encoder_name}",
                              frames, **kwargs)
        tokens = tokens.reshape(b, t, -1, tokens.shape[-1])
        if self.use_token_learner:
            tokens = self.token_learner(params, f"{prefix}/TokenLearner_0",
                                        tokens, draws)
        if self.proper_pad_mask:
            mask = generate_proper_pad_mask(
                tokens, observations.get("pad_mask_dict"), matched)
        else:
            mask = torch.ones(tokens.shape[:-1], dtype=torch.bool,
                              device=tokens.device)
        return TokenGroup(tokens, mask)

    def specs(self, prefix: str, observations, tasks=None):
        observations, tasks = _shapes(observations), _shapes(tasks or {})
        inputs = self._inputs(observations, tasks)
        if inputs is None:
            return {}
        frames, cond, _, _, _ = inputs
        enc = f"{prefix}/{self.encoder_name}"
        specs = self.encoder.specs(
            enc, frames.shape[-1], None if cond is None else cond.shape[-1])
        if self.use_token_learner:
            n = self.encoder.num_tokens(*frames.shape[1:3])
            specs.update(self.token_learner.specs(
                f"{prefix}/TokenLearner_0", n, self.encoder.num_features))
        return specs


class LanguageTokenizer:
    """The task's language tokens: tasks["language_instruction"] holds
    precomputed token embeddings (B, L, D), or (B, D) given a token axis,
    or, with `encoder` (a T5 name of models/encoders/t5.py, e.g.
    "t5-base"), a dict of input_ids and attention_mask that the in-model
    T5 embeds. The T5's params live under `<prefix>/hf_model/` in the keys
    of models/encoders/t5.py (the JAX module's submodule name);
    `load_weights` puts the pretrained ones there. Without
    finetune_encoder the tokens are detached."""

    def __init__(self, encoder: Optional[str] = None,
                 proper_pad_mask: bool = True,
                 finetune_encoder: bool = False):
        self.encoder = encoder
        self.proper_pad_mask = proper_pad_mask
        self.finetune_encoder = finetune_encoder

    def __call__(self, params, prefix: str, observations, tasks=None,
                 draws=None):
        if "language_instruction" not in tasks:
            logging.warning(
                "No language inputs found. Skipping tokenizer entirely.")
            assert self.proper_pad_mask, (
                "Cannot skip unless using proper pad mask.")
            return None
        instruction = tasks["language_instruction"]
        if isinstance(instruction, torch.Tensor):
            tokens = instruction[:, None, :] if instruction.dim() == 2 \
                else instruction
        else:
            assert self.encoder is not None, (
                "Received language tokens but no encoder specified.")
            tokens = t5_encode(t5_config(self.encoder),
                               subtree(params, f"{prefix}/hf_model/"),
                               instruction["input_ids"],
                               instruction["attention_mask"])
        if not self.finetune_encoder:
            tokens = tokens.detach()
        if self.proper_pad_mask:
            mask = generate_proper_pad_mask(
                tokens, tasks.get("pad_mask_dict"), ("language_instruction",))
        else:
            mask = torch.ones(tokens.shape[:-1], dtype=torch.bool,
                              device=tokens.device)
        return TokenGroup(tokens, mask)

    def specs(self, prefix: str, observations=None, tasks=None):
        if self.encoder is None:
            return {}
        return {f"{prefix}/hf_model/{k}": v
                for k, v in t5_specs(t5_config(self.encoder)).items()}

    def load_weights(self, params, prefix: str, device=None):
        """params with the in-model T5's leaves replaced by the pretrained
        ones of models/encoders/pretrained.py::load_t5_weights where there
        are any (the JAX package's hf_weights_loader), else as they are."""
        if self.encoder is None:
            return params
        weights = load_t5_weights(self.encoder, device=device)
        if weights is None:
            return params
        out = dict(params)
        for key, value in weights.items():
            name = f"{prefix}/hf_model/{key}"
            if name not in out or out[name].shape != value.shape:
                raise ValueError(f"pretrained {self.encoder} leaf {key} does "
                                 "not fit the tokenizer's T5")
            out[name] = value.to(out[name].device, out[name].dtype)
        return out


class LowdimObsTokenizer(BinTokenizer):
    """Non-spatial observations (B, T, D) as tokens: each value a token
    of width 1, or with discretize a one-hot of its bin."""

    def __init__(self, obs_keys: Sequence[str] = tuple(),
                 proper_pad_mask: bool = True, discretize: bool = False,
                 bin_type: str = "uniform", n_bins: int = 256,
                 low: float = -1.0, high: float = 1.0):
        super().__init__(bin_type, n_bins, low, high)
        self.obs_keys = tuple(obs_keys)
        self.proper_pad_mask = proper_pad_mask
        self.discretize = discretize

    def __call__(self, params, prefix: str, observations, tasks=None,
                 draws=None):
        assert self.obs_keys, "Need to specify observation keys to tokenize."
        matched = []
        for pattern in self.obs_keys:
            matched += [k for k in sorted(observations.keys())
                        if re.compile(pattern).match(k)]
        if not matched:
            logging.warning(f"No observation inputs matching "
                            f"{self.obs_keys} found; skipping.")
            assert self.proper_pad_mask, (
                "Cannot skip unless using proper pad mask.")
            return None
        for key in matched:
            assert observations[key].dim() == 3, (
                f"Only non-spatial inputs supported; {key} has shape "
                f"{tuple(observations[key].shape)}.")
        values = _gather_matching(observations, matched)
        if self.discretize:
            tokens = F.one_hot(BinTokenizer.__call__(self, values).long(),
                               self.n_bins).float()
        else:
            tokens = values[..., None]
        return TokenGroup(tokens, torch.ones(tokens.shape[:-1],
                                             dtype=torch.bool,
                                             device=tokens.device))

    def specs(self, prefix: str, observations, tasks=None):
        return {}
