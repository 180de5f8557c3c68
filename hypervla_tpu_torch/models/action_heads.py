"""The action heads (counterpart of hypervla_tpu/models/action_heads.py),
with their training losses: `MixActionHead`, tanh-squashed continuous arm
dims plus a binary gripper decoded from the sign of its logit;
`ContinuousActionHead`, tanh-squashed regression of every action dim, and
its MAP-pooled `MSEActionHead` and `L1ActionHead`; `DiscreteActionHead`,
logits over a BinTokenizer vocabulary, decoded by argmax or sampled, and
`TokenPerDimActionHead`; `DiffusionActionHead`, an MLP-ResNet DDPM head
(models/diffusion.py) that samples its actions in 20 denoising steps;
`UNetDDPMActionHead`, a DDPM head over a 1-D conditional U-Net
(models/unet.py). Each predicts a chunk of `action_horizon` actions at
each window step; all but the U-Net head decode the last one.

A head reads its params under "action_head/" and the readout tokens
(B, window, n, emb), a tensor or a TokenGroup (whose mask the MAP pooling
reads). The JAX BaseNetwork builds the first four from action_head_kwargs
(per-sample losses, no MAP pooling); the Octo topology
(models/base_octo.py) builds any of them from the JAX head's fields by
ModuleSpec, with MAP pooling (`use_map`: models/transformer.py::map_head
under action_head/map_head) where the spec asks, and takes their losses
over the whole batch (`per_sample=False`: the JAX head's loss outside a
per-sample vmap).
"""
import logging
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from hypervla_tpu_torch.models import layers
from hypervla_tpu_torch.models.diffusion import (
    ScoreActor,
    blocked_cumprod,
    unet_squaredcos_cap_v2,
)
from hypervla_tpu_torch.models.draws import Draws
from hypervla_tpu_torch.models.token_group import tokens_and_mask
from hypervla_tpu_torch.models.tokenizers import BinTokenizer
from hypervla_tpu_torch.models.transformer import map_head, map_head_specs
from hypervla_tpu_torch.models.unet import ConditionalUnet1D

MAP_HEAD = "action_head/map_head"


#: the per-element penalties of continuous_loss
PENALTIES = {"mse": torch.square, "l1": torch.abs}


def masked_mean(x, mask, per_sample: bool = True):
    """Per-sample mean of x where the (broadcast) mask is set, as the JAX
    package's masked_mean takes it inside its per-sample vmap:
    mean(x * mask) / max(mean(mask), 1e-5) over all but the leading axis;
    with per_sample=False over every axis (a scalar), as the Octo
    topology takes it over the batch."""
    mask = mask.expand_as(x).to(x.dtype)
    if not per_sample:
        return masked_mean(x[None], mask[None])[0]
    denom = torch.clamp(mask.flatten(1).mean(1), min=1e-5)
    return (x * mask).flatten(1).mean(1) / denom


def continuous_loss(pred, target, mask, loss_type: str = "mse",
                    per_sample: bool = True):
    """Per-sample masked penalty of pred - target and its metrics
    {"loss", "mse"} (hypervla_tpu/models/action_heads.py::
    continuous_loss)."""
    if loss_type not in PENALTIES:
        raise ValueError(f"Invalid loss type: {loss_type}")
    err = pred - target
    loss = masked_mean(PENALTIES[loss_type](err), mask, per_sample)
    mse = (loss if loss_type == "mse"
           else masked_mean(torch.square(err), mask, per_sample))
    return loss, {"loss": loss, "mse": mse}


def chunk_mask(timestep_pad_mask, action_pad_mask):
    """(B, window) & (B, window, horizon, action_dim) -> the per-element
    loss mask."""
    return timestep_pad_mask[:, :, None, None] & action_pad_mask


def _head(params, name, x):
    return layers.dense(x, params[f"action_head/{name}/kernel"],
                        params[f"action_head/{name}/bias"])


def _dense_specs(name, fan_in, fan_out):
    return {f"action_head/{name}/bias": ((fan_out,), layers.zeros),
            f"action_head/{name}/kernel": ((fan_in, fan_out),
                                           layers.lecun_normal)}


def discrete_loss(tokenizer: BinTokenizer, logits, target, mask,
                  per_sample: bool = True):
    """Per-sample cross-entropy of logits (B, ..., vocab) against the
    tokenized targets, and the metrics {"loss", "mse", "accuracy"}: the
    argmax token's agreement and its decoded value's squared error, all
    masked means (hypervla_tpu/models/action_heads.py::discrete_loss)."""
    labels = tokenizer(target)
    nll = -torch.gather(F.log_softmax(logits, dim=-1), -1,
                        labels[..., None].long())[..., 0]
    loss = masked_mean(nll, mask, per_sample)
    pred = logits.argmax(-1)
    accuracy = masked_mean((pred == labels).float(), mask, per_sample)
    mse = masked_mean(torch.square(tokenizer.decode(pred) - target), mask,
                      per_sample)
    return loss, {"loss": loss, "mse": mse, "accuracy": accuracy}


def pooled_readout(params, readout, use_map: bool, draws=None,
                   flatten: bool = False):
    """(B, w, n, emb) readout tokens (or a TokenGroup) -> (B, w, emb'):
    MAP pooling with use_map (its MLP's dropout where draws are given),
    the tokens flattened with flatten, else their mean."""
    tokens, mask = tokens_and_mask(readout)
    assert tokens.dim() == 4, (f"expected (batch, window, tokens, emb), "
                               f"got {tuple(tokens.shape)}")
    if use_map:
        return map_head(params, MAP_HEAD, tokens, mask, draws=draws)[:, :, 0]
    if flatten:
        return tokens.reshape(*tokens.shape[:2], -1)
    return tokens.mean(-2)


def _last_step(per_window, sample_shape=()):
    """The last window step's chunk, broadcast to sample_shape."""
    last = per_window[:, -1]
    return last.expand(*sample_shape, *last.shape)


class ChunkedHead:
    """The settings the regression heads share: the chunk geometry, the
    loss type and the tanh squashing and target clipping."""

    def __init__(self, action_horizon: int, action_dim: int,
                 action_head_kwargs: dict):
        kw = action_head_kwargs
        self.action_horizon = action_horizon
        self.action_dim = action_dim
        self.token_per_horizon = kw.get("token_per_horizon", False)
        self.loss_type = kw.get("loss_type", "mse")
        self.squash = kw.get("squash_continuous_action", True)
        self.tanh_scaling_factor = kw.get("tanh_scaling_factor", 5.0)
        self.max_action = kw.get("max_action", 5.0)
        self.clip_target = kw.get("clip_target", False)

    def _maybe_squash(self, x):
        if not self.squash:
            return x
        return torch.tanh(x / self.tanh_scaling_factor) * self.max_action

    def _maybe_clip_target(self, actions):
        if not self.clip_target:
            return actions
        return torch.clamp(actions, -self.max_action, self.max_action)


#: the keys the JAX BaseNetwork passes every head itself: one of them in
#: action_head_kwargs reaches ContinuousActionHead(**common, **kw) twice
COMMON_KEYS = ("readout_key", "use_map", "action_horizon", "action_dim")
#: the JAX ContinuousActionHead's fields past the common ones
CONTINUOUS_FIELDS = ("token_per_horizon", "loss_type", "max_action",
                     "tanh_scaling_factor", "squash_continuous_action",
                     "clip_target")


class ContinuousActionHead(ChunkedHead):
    """Tanh-squashed continuous regression of every action dim, from the
    mean of the readout tokens (with use_map, their MAP pooling).

    Built by the JAX BaseNetwork's rule, `(action_horizon, action_dim,
    action_head_kwargs)`, it reads only its own keys of
    action_head_kwargs (the JAX head takes every key as a field and raises
    on the other heads' keys that the JAX configs carry); hidden layers are
    the mix head's, and a config that asks the continuous head for them
    raises. A key that the JAX BaseNetwork passes itself (use_map among
    them) raises TypeError, as it reaches the JAX head twice. Built by its
    JAX fields as keywords (an Octo ModuleSpec), an unknown field raises
    TypeError, as the JAX dataclass does."""

    #: the JAX class's own field defaults (MSEActionHead, L1ActionHead)
    FIELD_DEFAULTS: Dict[str, object] = {}

    def __init__(self, action_horizon: int = 1, action_dim: int = 7,
                 action_head_kwargs: Optional[dict] = None, *,
                 readout_key: Optional[str] = None, **fields):
        name = type(self).__name__
        if action_head_kwargs is None:
            fields = {**self.FIELD_DEFAULTS, **fields}
            unknown = set(fields) - {"use_map", *CONTINUOUS_FIELDS}
            if unknown:
                raise TypeError(f"{name} got an unexpected keyword argument "
                                f"{sorted(unknown)[0]!r}")
            action_head_kwargs = fields
        else:
            if fields:
                raise TypeError(f"{name}: pass action_head_kwargs or the "
                                "head's fields, not both")
            for key in COMMON_KEYS:
                if key in action_head_kwargs:
                    raise TypeError(
                        f"ContinuousActionHead got multiple values for "
                        f"keyword argument {key!r}: BaseNetwork passes it "
                        "itself, and action_head_kwargs carry it too")
            if tuple(action_head_kwargs.get("hidden_dims", ())):
                raise ValueError("action_head_kwargs hidden_dims: the "
                                 "continuous head has no hidden layers "
                                 "(they are the mix head's)")
        super().__init__(action_horizon, action_dim, action_head_kwargs)
        self.readout_key = readout_key
        self.use_map = bool(fields.get("use_map", False))

    def __call__(self, params: Dict[str, torch.Tensor], tokens, draws=None):
        """tokens (B, window, n, emb) -> (B, window, horizon, action_dim)."""
        mean = _head(params, "mean_proj",
                     pooled_readout(params, tokens, self.use_map, draws))
        mean = mean.reshape(*mean.shape[:2], self.action_horizon,
                            self.action_dim)
        return self._maybe_squash(mean)

    def loss(self, params: Dict[str, torch.Tensor], tokens, actions,
             timestep_pad_mask, action_pad_mask, draws=None,
             per_sample: bool = True):
        """Per-sample loss (B,) and metrics {"loss", "mse"}, each a per-dim
        mean times action_dim."""
        loss, metrics = continuous_loss(
            self(params, tokens, draws), self._maybe_clip_target(actions),
            chunk_mask(timestep_pad_mask, action_pad_mask), self.loss_type,
            per_sample)
        return loss * self.action_dim, {k: v * self.action_dim
                                        for k, v in metrics.items()}

    def predict_action(self, params, tokens, draws=None, *,
                       sample_shape: tuple = (), **unused):
        """The last window step's chunk (B, horizon, action_dim), broadcast
        to sample_shape; draws are not read (the decode is
        deterministic)."""
        return _last_step(self(params, tokens), sample_shape)

    def specs(self, emb_dim: int) -> Dict[str, Tuple[tuple, layers.Init]]:
        specs = _dense_specs("mean_proj", emb_dim,
                             self.action_horizon * self.action_dim)
        if self.use_map:
            specs.update(map_head_specs(MAP_HEAD, emb_dim))
        return specs


class MSEActionHead(ContinuousActionHead):
    """MAP-pooled continuous head, squared-error loss."""

    FIELD_DEFAULTS = {"use_map": True, "loss_type": "mse", "max_action": 5.0}


class L1ActionHead(ContinuousActionHead):
    """MAP-pooled continuous head, absolute-error loss."""

    FIELD_DEFAULTS = {"use_map": True, "loss_type": "l1", "max_action": 5.0}


class MixActionHead(ChunkedHead):
    """Continuous arm dims plus a binary gripper dim. With
    token_per_horizon one readout token per horizon step emits that step,
    else one token emits the whole chunk; hidden_dims put Dense ->
    LayerNorm -> swish layers before the two heads."""

    def __init__(self, action_horizon: int, action_dim: int,
                 action_head_kwargs: dict):
        super().__init__(action_horizon, action_dim, action_head_kwargs)
        self.hidden_dims = tuple(action_head_kwargs.get("hidden_dims", ()))
        # the JAX BaseNetwork builds the mix head from named keys, so it
        # takes neither use_map nor loss_type from action_head_kwargs
        self.loss_type = "mse"

    def __call__(self, params: Dict[str, torch.Tensor], tokens, draws=None):
        """tokens (B, window, n, emb), n = horizon with token_per_horizon
        else 1 -> (arm (B, window, horizon, action_dim - 1),
        gripper_logits (B, window, horizon, 1))."""
        tokens = tokens_and_mask(tokens)[0]
        expected = self.action_horizon if self.token_per_horizon else 1
        if tokens.shape[2] != expected:
            raise ValueError(f"token number {tokens.shape[2]} != {expected}")
        # (B, window * tokens, emb): a per-sample kernel (B, emb, out)
        # applies as one batched matmul
        emb = tokens.flatten(1, 2)
        for i in range(len(self.hidden_dims)):
            emb = _head(params, f"Dense_{i}", emb)
            emb = F.silu(layers.layer_norm(
                emb, params[f"action_head/LayerNorm_{i}/scale"],
                params[f"action_head/LayerNorm_{i}/bias"]))
        lead = tokens.shape[:2]
        arm = _head(params, "continuous_head", emb).reshape(
            *lead, self.action_horizon, self.action_dim - 1)
        grip = _head(params, "discrete_head", emb).reshape(
            *lead, self.action_horizon, 1)
        return self._maybe_squash(arm), grip

    def loss(self, params: Dict[str, torch.Tensor], tokens, actions,
             timestep_pad_mask, action_pad_mask, draws=None):
        """Per-sample loss (B,) and metrics: the masked arm loss times
        (action_dim - 1) plus the masked sigmoid cross-entropy of the
        gripper. actions, action_pad_mask (B, window, horizon, action_dim);
        timestep_pad_mask (B, window)."""
        arm, grip = self(params, tokens)
        actions = self._maybe_clip_target(actions)
        mask = chunk_mask(timestep_pad_mask, action_pad_mask)
        arm_loss, _ = continuous_loss(arm, actions[..., :-1], mask[..., :-1],
                                      self.loss_type)
        arm_loss = arm_loss * (self.action_dim - 1)
        bce = F.binary_cross_entropy_with_logits(
            grip, actions[..., -1:], reduction="none")
        gripper_loss = masked_mean(bce, mask[..., -1:])
        return arm_loss + gripper_loss, {"continuous_loss": arm_loss,
                                         "gripper_loss": gripper_loss}

    def predict_action(self, params, tokens, draws=None, **unused):
        """The last window step's chunk (B, horizon, action_dim), gripper
        decoded as (logit >= 0); draws are not read."""
        arm, grip = self(params, tokens)
        action = torch.cat([arm, (grip >= 0.0).float()], dim=-1)
        return action[:, -1]

    def specs(self, emb_dim: int) -> Dict[str, Tuple[tuple, layers.Init]]:
        specs = {}
        for i, dim in enumerate(self.hidden_dims):
            specs.update(_dense_specs(f"Dense_{i}", emb_dim, dim))
            specs[f"action_head/LayerNorm_{i}/bias"] = ((dim,), layers.zeros)
            specs[f"action_head/LayerNorm_{i}/scale"] = ((dim,), layers.ones)
            emb_dim = dim
        per_token = self.token_per_horizon
        horizon = 1 if per_token else self.action_horizon
        specs.update(_dense_specs("continuous_head", emb_dim,
                                  horizon * (self.action_dim - 1)))
        specs.update(_dense_specs("discrete_head", emb_dim, horizon))
        return specs


class DiscreteActionHead:
    """Logits over a BinTokenizer vocabulary for every (horizon step,
    action dim), from the readout tokens: token_per "" reads one token for
    the whole chunk, "action_horizon" one a horizon step,
    "action_dim_and_action_horizon" one a (step, dim). The loss is the
    cross-entropy against the tokenized targets; the decode takes each
    logit row's argmax token's bin centre."""

    def __init__(self, action_horizon: int = 1, action_dim: int = 7,
                 token_per: str = "action_dim_and_action_horizon",
                 vocab_size: int = 256, normalization_type: str = "uniform",
                 *, readout_key: Optional[str] = None,
                 use_map: bool = False):
        layouts = {"": 1, "action_horizon": action_horizon,
                   "action_dim_and_action_horizon":
                       action_horizon * action_dim}
        if token_per not in layouts:
            raise ValueError(f"Invalid token_per: {token_per}")
        self.readout_key = readout_key
        self.use_map = use_map
        self.action_horizon = action_horizon
        self.action_dim = action_dim
        self.vocab_size = vocab_size
        self.n_tokens = layouts[token_per]
        self.final_layer_size = (action_horizon * action_dim
                                 * vocab_size) // self.n_tokens
        self.tokenizer = BinTokenizer(normalization_type, vocab_size)

    def __call__(self, params: Dict[str, torch.Tensor], tokens, draws=None):
        """tokens (B, window, n, emb), n = n_tokens without use_map ->
        logits (B, window, horizon, action_dim, vocab)."""
        tokens, mask = tokens_and_mask(tokens)
        if self.use_map:
            tokens = map_head(params, MAP_HEAD, tokens, mask,
                              num_readouts=self.n_tokens, draws=draws)
        elif tokens.shape[2] != self.n_tokens:
            raise ValueError(f"discrete head expects {self.n_tokens} tokens, "
                             f"got {tokens.shape[2]}")
        logits = _head(params, "vocab_proj", tokens.flatten(1, 2))
        return logits.reshape(*tokens.shape[:2], self.action_horizon,
                              self.action_dim, self.vocab_size)

    def loss(self, params: Dict[str, torch.Tensor], tokens, actions,
             timestep_pad_mask, action_pad_mask, draws=None,
             per_sample: bool = True):
        """Per-sample loss (B,) and metrics {"loss", "mse", "accuracy"},
        the mse times action_dim."""
        loss, metrics = discrete_loss(
            self.tokenizer, self(params, tokens, draws), actions,
            chunk_mask(timestep_pad_mask, action_pad_mask), per_sample)
        metrics["mse"] = metrics["mse"] * self.action_dim
        return loss, metrics

    def predict_action(self, params, tokens, draws=None, *,
                       argmax: bool = False, temperature: float = 1.0,
                       sample_shape: tuple = (), **unused):
        """The last window step's chunk (*sample_shape, B, horizon,
        action_dim), each token's bin centre: the argmax token with argmax
        (the JAX BaseNetwork asks for it; draws are not read), else a
        token sampled from softmax(logits / temperature), by the Gumbel
        draws "action_head/gumbel" (*sample_shape, B, horizon, action_dim,
        vocab) as jax.random.categorical samples."""
        logits = self(params, tokens)[:, -1]
        if argmax:
            choice = logits.argmax(-1)
            choice = choice.expand(*sample_shape, *choice.shape)
        else:
            if draws is None:
                raise ValueError("sampling the discrete head's tokens: pass "
                                 "rng (a torch.Generator or Draws), or "
                                 "argmax=True")
            gumbel = draws.gumbel("action_head/gumbel",
                                  (*sample_shape, *logits.shape),
                                  logits.device)
            choice = (gumbel + logits / temperature).argmax(-1)
        return self.tokenizer.decode(choice)

    def specs(self, emb_dim: int) -> Dict[str, Tuple[tuple, layers.Init]]:
        specs = _dense_specs("vocab_proj", emb_dim, self.final_layer_size)
        if self.use_map:
            specs.update(map_head_specs(MAP_HEAD, emb_dim, self.n_tokens))
        return specs


class TokenPerDimActionHead(DiscreteActionHead):
    """The discrete head reading one token a (horizon step, action dim)."""


@dataclass(frozen=True)
class DDPMSchedule:
    """The cosine schedule's fp32 arrays (on the host) and the DDPM
    algebra over them."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alpha_bars: torch.Tensor

    @classmethod
    def cosine(cls, timesteps: int) -> "DDPMSchedule":
        betas = unet_squaredcos_cap_v2(timesteps)
        alphas = 1.0 - betas
        return cls(betas=betas, alphas=alphas,
                   alpha_bars=blocked_cumprod(alphas))

    @property
    def num_steps(self) -> int:
        return self.betas.shape[0]

    def q_sample(self, x0, t, eps):
        """The forward process: x0 noised to steps t (an integer tensor
        that broadcasts against x0)."""
        alpha_bars = self.alpha_bars.to(x0.device)[t.long()]
        return torch.sqrt(alpha_bars) * x0 + torch.sqrt(1 - alpha_bars) * eps

    def reverse_coefficients(self, device):
        """Per step t, as fp32 arrays on `device`: (1 - alpha_t) /
        sqrt(1 - alpha_bar_t), sqrt(alpha_t), sqrt(beta_t) and
        sqrt(1 - alpha_bar_t), the scalars of a denoising step, computed
        in fp32 on the host as the JAX step computes them."""
        one_minus_bar = torch.sqrt(1 - self.alpha_bars)
        arrays = ((1 - self.alphas) / one_minus_bar, torch.sqrt(self.alphas),
                  torch.sqrt(self.betas), one_minus_bar)
        return tuple(a.to(device) for a in arrays)


def embodiment_mask(lead_shape, action_horizon: int, action_dim: int,
                    embodiment_action_dim: int, device=None):
    """Boolean (*lead_shape, horizon, dim) mask of the valid action dims:
    the dims past the embodiment's stay noise while the diffusion head
    samples."""
    mask = torch.ones((*lead_shape, action_horizon, action_dim),
                      dtype=torch.bool, device=device)
    mask[..., embodiment_action_dim:] = False
    return mask


class DiffusionActionHead:
    """The MLP-ResNet DDPM head: the score network (models/diffusion.py)
    predicts the noise of noised action chunks from the mean of the readout
    tokens, trained on eps with the cosine schedule, and samples by
    `diffusion_steps` reverse steps from N(0, 1).

    Its random numbers come from a models/draws.py::Draws (a generator's,
    or replayed by site): in the loss, per sample, the steps
    "action_head/time" (B, n_diffusion_samples, window, 1) and the noise
    "action_head/noise" (B, n_diffusion_samples, window, horizon *
    action_dim), and the score network's dropout; in predict_action the
    start "action_head/x_T" (B, window, horizon * action_dim) and the noise
    of the step to t, "action_head/z/<t>", t from diffusion_steps - 1 down
    to 0 (the JAX head's split chain)."""

    prefix = "action_head/diffusion_model"

    def __init__(self, action_horizon: int = 1, action_dim: int = 7,
                 max_action: float = 5.0, loss_type: str = "mse",
                 hidden_dim: int = 256, num_blocks: int = 3,
                 time_dim: int = 32, use_layer_norm: bool = True,
                 dropout_rate: float = 0.0, diffusion_steps: int = 20,
                 n_diffusion_samples: int = 1, *,
                 readout_key: Optional[str] = None, use_map: bool = False):
        self.readout_key = readout_key
        self.use_map = use_map
        self.action_horizon = action_horizon
        self.action_dim = action_dim
        self.max_action = max_action
        self.loss_type = loss_type
        self.n_diffusion_samples = n_diffusion_samples
        self.flat_dim = action_horizon * action_dim
        self.model = ScoreActor(self.prefix, self.flat_dim, time_dim,
                                num_blocks, hidden_dim, dropout_rate,
                                use_layer_norm)
        self.schedule = DDPMSchedule.cosine(diffusion_steps)
        self._coefficients = {}
        self._warned = False

    def __call__(self, params: Dict[str, torch.Tensor], tokens, time,
                 noisy_actions, draws: Optional[Draws] = None):
        """The predicted noise: tokens (B, window, n, emb) pooled
        (pooled_readout), time (B, ..., window, 1), noisy_actions
        (B, ..., window, flat)."""
        emb = pooled_readout(params, tokens, self.use_map, draws)
        if time.dim() > emb.dim():
            emb = emb[:, None].expand(*time.shape[:-1], emb.shape[-1])
        return self.model(params, emb, noisy_actions, time, draws)

    def loss(self, params: Dict[str, torch.Tensor], tokens, actions,
             timestep_pad_mask, action_pad_mask,
             draws: Optional[Draws] = None, per_sample: bool = True):
        """Per-sample eps-prediction loss (B,) and metrics {"loss",
        "mse"}, each times action_dim. draws give each sample's steps and
        noise (and the score network's dropout), batch-leading either way
        (the JAX head outside a vmap draws them (n_diffusion_samples, B,
        ...))."""
        if draws is None:
            raise ValueError("the diffusion loss draws its steps and noise: "
                             "pass draws")
        batch, window = timestep_pad_mask.shape
        dev = actions.device
        x0 = torch.clamp(actions.reshape(batch, window, self.flat_dim),
                         -self.max_action, self.max_action)
        lead = (batch, self.n_diffusion_samples, window)
        time = draws.randint("action_head/time", (*lead, 1), 0,
                             self.schedule.num_steps, dev)
        noise = draws.normal("action_head/noise", (*lead, self.flat_dim),
                             dev)
        noisy = self.schedule.q_sample(x0[:, None], time, noise)
        pred = self(params, tokens, time, noisy, draws)
        mask = chunk_mask(timestep_pad_mask, action_pad_mask).reshape(
            batch, 1, window, self.flat_dim)
        loss, metrics = continuous_loss(pred, noise, mask, self.loss_type,
                                        per_sample)
        return loss * self.action_dim, {k: v * self.action_dim
                                        for k, v in metrics.items()}

    def predict_action(self, params, tokens, draws: Optional[Draws] = None,
                       embodiment_action_dim: Optional[int] = None, *,
                       sample_shape: tuple = (), **unused):
        """The last window step's sampled chunk (*sample_shape, B, horizon,
        action_dim), by the reverse process from x_T ~ N(0, 1), each step's
        result clipped to +-max_action; dims past embodiment_action_dim are
        set to the step's noise level times its draw (without
        embodiment_action_dim every dim is sampled, and the first call
        warns). The draws are (*sample_shape, B, window, horizon *
        action_dim)."""
        if draws is None:
            raise ValueError("the diffusion head samples its actions: pass "
                             "rng (a torch.Generator or Draws)")
        batch, window = tokens_and_mask(tokens)[0].shape[:2]
        dev = tokens_and_mask(tokens)[0].device
        lead = (*sample_shape, batch, window)
        key = str(dev)
        if key not in self._coefficients:
            self._coefficients[key] = self.schedule.reverse_coefficients(dev)
        eps_coef, sqrt_alpha, sqrt_beta, noise_level = self._coefficients[key]
        mask = None
        if embodiment_action_dim is not None:
            mask = embodiment_mask(lead, self.action_horizon,
                                   self.action_dim, embodiment_action_dim,
                                   dev).reshape(*lead, self.flat_dim)
        elif not self._warned:  # the JAX head warns once, when it traces
            self._warned = True
            logging.warning(
                "embodiment_action_dim is recommended for the diffusion "
                "head if any action dimensions were masked during training")
        emb = pooled_readout(params, tokens, self.use_map)
        emb = emb.expand(*lead, emb.shape[-1])
        x = draws.normal("action_head/x_T", (*lead, self.flat_dim), dev)
        for t in range(self.schedule.num_steps - 1, -1, -1):
            time = torch.full((*lead, 1), float(t), device=dev)
            eps = self.model(params, emb, x, time)
            x = (x - eps_coef[t] * eps) / sqrt_alpha[t]
            z = draws.normal(f"action_head/z/{t}", x.shape, dev)
            if t > 0:
                x = x + sqrt_beta[t] * z
            x = torch.clamp(x, -self.max_action, self.max_action)
            if mask is not None:
                x = torch.where(mask, x, noise_level[t] * z)
        actions = x.reshape(*lead, self.action_horizon, self.action_dim)
        return actions[..., -1, :, :]

    def specs(self, emb_dim: int) -> Dict[str, Tuple[tuple, layers.Init]]:
        specs = self.model.specs(emb_dim)
        if self.use_map:
            specs.update(map_head_specs(MAP_HEAD, emb_dim))
        return specs


class UNetDDPMActionHead:
    """The DDPM head over a 1-D conditional U-Net (models/unet.py, under
    action_head/model; its output projected to action_dim by
    action_head/action_proj): eps-prediction on the cosine schedule of
    `timesteps` steps, sampling with the DDPM posterior (variance
    "fixed_large" or "fixed_small", the x0 estimate clipped to
    clip_sample where given). Its draws: in the loss "action_head/time"
    (B, window, 1) and "action_head/noise" (B, window, horizon,
    action_dim); sampling "action_head/x_T" and "action_head/z/<t>" (B,
    window, horizon, action_dim), t from timesteps - 1 down to 0. Its
    predict_action returns every window step's chunk, as the JAX head's
    does. The JAX head's loss takes (actions, action_pad_mask,
    timestep_pad_mask) in that order, and so does this one."""

    def __init__(self, readout_key: str, action_dim: int,
                 action_horizon: int, flatten_tokens: bool = False,
                 use_map: bool = False, max_action: float = 1.0,
                 timesteps: int = 100, variance_type: str = "fixed_large",
                 clip_sample: Optional[float] = None):
        self.readout_key = readout_key
        self.action_dim = action_dim
        self.action_horizon = action_horizon
        self.flatten_tokens = flatten_tokens
        self.use_map = use_map
        self.max_action = max_action
        self.timesteps = timesteps
        self.variance_type = variance_type
        self.clip_sample = clip_sample
        self.schedule = DDPMSchedule.cosine(timesteps)
        self.model = ConditionalUnet1D(down_features=(256, 512, 1024),
                                       mid_layers=2, time_features=128,
                                       kernel_size=5)
        self._warned = False

    def __call__(self, params: Dict[str, torch.Tensor], tokens, time,
                 noisy_actions, draws: Optional[Draws] = None):
        assert not (self.use_map and self.flatten_tokens), (
            "Cannot use MAP and flattening!")
        emb = pooled_readout(params, tokens, self.use_map, draws,
                             flatten=self.flatten_tokens)
        eps = self.model(params, "action_head/model", emb, noisy_actions,
                         time)
        return _head(params, "action_proj", eps)

    def loss(self, params: Dict[str, torch.Tensor], tokens, actions,
             action_pad_mask, timestep_pad_mask,
             draws: Optional[Draws] = None, per_sample: bool = True):
        if draws is None:
            raise ValueError("the diffusion loss draws its steps and noise: "
                             "pass draws")
        batch, window = timestep_pad_mask.shape[:2]
        dev = actions.device
        x0 = torch.clamp(actions, -self.max_action, self.max_action)
        time = draws.randint("action_head/time", (batch, window, 1), 0,
                             self.timesteps, dev)
        noise = draws.normal("action_head/noise", x0.shape, dev)
        noisy = self.schedule.q_sample(x0, time[:, None], noise)
        pred = self(params, tokens, time, noisy, draws)
        mask = (action_pad_mask[:, None, None, :].expand(x0.shape)
                * timestep_pad_mask)
        loss, metrics = continuous_loss(pred, noise, mask, "mse", per_sample)
        return loss * self.action_dim, {k: v * self.action_dim
                                        for k, v in metrics.items()}

    def predict_action(self, params, tokens, draws: Optional[Draws] = None,
                       embodiment_action_dim: Optional[int] = None,
                       **unused):
        """Every window step's sampled chunk (B, window, horizon,
        action_dim). The JAX sampler samples a batch of one: its step's
        scalars (B, 1, 1) broadcast against (B, 1, horizon, dim) make a
        (B, B, ...) chunk for a larger one, which its scan refuses with
        TypeError; so does this one."""
        if draws is None:
            raise ValueError("the diffusion head samples its actions: pass "
                             "rng (a torch.Generator or Draws)")
        sched = self.schedule
        readout = tokens_and_mask(tokens)[0]
        batch, window = readout.shape[:2]
        dev = readout.device
        shape = (batch, window, self.action_horizon, self.action_dim)
        if embodiment_action_dim is None:
            mask = torch.ones(shape, dtype=torch.bool, device=dev)
            if not self._warned:
                self._warned = True
                logging.warning(
                    "embodiment_action_dim is recommended for the diffusion "
                    "head if any action dimensions were masked during "
                    "training")
        else:
            mask = embodiment_mask((batch, window), self.action_horizon,
                                   self.action_dim, embodiment_action_dim,
                                   dev)
        alpha_bars = sched.alpha_bars.to(dev)
        alphas = sched.alphas.to(dev)
        x = draws.normal("action_head/x_T", shape, dev)
        for t in range(self.timesteps - 1, -1, -1):
            # the step's scalars at (B, 1, 1), as the JAX step reads them
            # (and broadcasts them against (B, window, horizon, dim))
            t_in = torch.full((batch, 1, 1), t, dtype=torch.int32,
                              device=dev)
            a_bar = alpha_bars[t_in.long()]
            a_bar_prev = (alpha_bars[t_in.long() - 1] if t > 0
                          else torch.ones_like(a_bar))
            alpha = alphas[t_in.long()]
            eps = self(params, tokens, t_in, x)
            x0_est = (x - torch.sqrt(1 - a_bar) * eps) / torch.sqrt(a_bar)
            if self.clip_sample is not None:
                x0_est = torch.clamp(x0_est, -self.clip_sample,
                                     self.clip_sample)
            x0_coeff = torch.sqrt(a_bar_prev) * (1 - alpha) / (1 - a_bar)
            xt_coeff = torch.sqrt(alpha) * (1 - a_bar_prev) / (1 - a_bar)
            x_prev = x0_coeff * x0_est + xt_coeff * x
            if self.variance_type == "fixed_large":
                var = 1 - alpha
            elif self.variance_type == "fixed_small":
                var = torch.clamp((1 - a_bar_prev) / (1 - a_bar)
                                  * (1 - alpha), min=1e-20)
            else:
                raise ValueError("Invalid schedule provided")
            if t == 0:
                var = torch.zeros_like(eps)
            z = draws.normal(f"action_head/z/{t}", shape, dev)
            x_prev = torch.where(mask, x_prev + torch.sqrt(var) * z,
                                 torch.sqrt(1 - a_bar) * z)
            if x_prev.shape != x.shape:
                # the JAX sampler's scan refuses the (B, 1, 1) scalars
                # broadcast against a batch of more than one
                raise TypeError(
                    "scan body function carry input and carry output must "
                    f"have equal types: {tuple(x.shape)} in, "
                    f"{tuple(x_prev.shape)} out")
            x = x_prev
        return x

    def specs(self, emb_dim: int) -> Dict[str, Tuple[tuple, layers.Init]]:
        out_dim = self.model.down_features[0]
        specs = self.model.specs("action_head/model", self.action_dim,
                                 emb_dim)
        specs.update(_dense_specs("action_proj", out_dim, self.action_dim))
        if self.use_map:
            specs.update(map_head_specs(MAP_HEAD, emb_dim))
        return specs
