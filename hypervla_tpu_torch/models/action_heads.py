"""The action heads that the JAX package's BaseNetwork builds
(counterpart of hypervla_tpu/models/action_heads.py), with their training
losses: `MixActionHead`, tanh-squashed continuous arm dims plus a binary
gripper decoded from the sign of its logit; `ContinuousActionHead`,
tanh-squashed regression of every action dim; `DiscreteActionHead`, logits
over a BinTokenizer vocabulary, decoded by argmax; `DiffusionActionHead`,
an MLP-ResNet DDPM head (models/diffusion.py) that samples its actions in
20 denoising steps. Each predicts a chunk of `action_horizon` actions at
each window step and decodes the last one.

BaseNetwork never builds the JAX package's MAP-pooled heads (MSE, L1),
its TokenPerDim head or its U-Net DDPM head, nor MAP pooling (it passes
use_map=False to every head): those belong to the Octo topology
(ROADMAP.md A12.2).
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
from hypervla_tpu_torch.models.tokenizers import BinTokenizer


#: the per-element penalties of continuous_loss
PENALTIES = {"mse": torch.square, "l1": torch.abs}


def masked_mean(x, mask):
    """Per-sample mean of x where the (broadcast) mask is set, as the JAX
    package's masked_mean takes it inside its per-sample vmap:
    mean(x * mask) / max(mean(mask), 1e-5) over all but the leading axis."""
    mask = mask.expand_as(x).to(x.dtype)
    denom = torch.clamp(mask.flatten(1).mean(1), min=1e-5)
    return (x * mask).flatten(1).mean(1) / denom


def continuous_loss(pred, target, mask, loss_type: str = "mse"):
    """Per-sample masked penalty of pred - target and its metrics
    {"loss", "mse"} (hypervla_tpu/models/action_heads.py::
    continuous_loss)."""
    if loss_type not in PENALTIES:
        raise ValueError(f"Invalid loss type: {loss_type}")
    err = pred - target
    loss = masked_mean(PENALTIES[loss_type](err), mask)
    mse = (loss if loss_type == "mse"
           else masked_mean(torch.square(err), mask))
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


def discrete_loss(tokenizer: BinTokenizer, logits, target, mask):
    """Per-sample cross-entropy of logits (B, ..., vocab) against the
    tokenized targets, and the metrics {"loss", "mse", "accuracy"}: the
    argmax token's agreement and its decoded value's squared error, all
    masked means (hypervla_tpu/models/action_heads.py::discrete_loss)."""
    labels = tokenizer(target)
    nll = -torch.gather(F.log_softmax(logits, dim=-1), -1,
                        labels[..., None].long())[..., 0]
    loss = masked_mean(nll, mask)
    pred = logits.argmax(-1)
    accuracy = masked_mean((pred == labels).float(), mask)
    mse = masked_mean(torch.square(tokenizer.decode(pred) - target), mask)
    return loss, {"loss": loss, "mse": mse, "accuracy": accuracy}


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


class ContinuousActionHead(ChunkedHead):
    """Tanh-squashed continuous regression of every action dim, from the
    mean of the readout tokens. It reads only its own keys of
    action_head_kwargs (the JAX head takes every key as a field and raises
    on the other heads' keys that the JAX configs carry); hidden layers are
    the mix head's, and a config that asks the continuous head for them
    raises. A key that the JAX BaseNetwork passes itself (use_map among
    them) raises TypeError, as it reaches the JAX head twice."""

    def __init__(self, action_horizon: int, action_dim: int,
                 action_head_kwargs: dict):
        for key in COMMON_KEYS:
            if key in action_head_kwargs:
                raise TypeError(
                    f"ContinuousActionHead got multiple values for keyword "
                    f"argument {key!r}: BaseNetwork passes it itself, and "
                    "action_head_kwargs carry it too")
        super().__init__(action_horizon, action_dim, action_head_kwargs)
        if tuple(action_head_kwargs.get("hidden_dims", ())):
            raise ValueError("action_head_kwargs hidden_dims: the "
                             "continuous head has no hidden layers (they "
                             "are the mix head's)")

    def __call__(self, params: Dict[str, torch.Tensor], tokens):
        """tokens (B, window, n, emb) -> (B, window, horizon, action_dim)."""
        mean = _head(params, "mean_proj", tokens.mean(-2))
        mean = mean.reshape(*mean.shape[:2], self.action_horizon,
                            self.action_dim)
        return self._maybe_squash(mean)

    def loss(self, params: Dict[str, torch.Tensor], tokens, actions,
             timestep_pad_mask, action_pad_mask, draws=None):
        """Per-sample loss (B,) and metrics {"loss", "mse"}, each a per-dim
        mean times action_dim."""
        loss, metrics = continuous_loss(
            self(params, tokens), self._maybe_clip_target(actions),
            chunk_mask(timestep_pad_mask, action_pad_mask), self.loss_type)
        return loss * self.action_dim, {k: v * self.action_dim
                                        for k, v in metrics.items()}

    def predict_action(self, params, tokens, draws=None):
        """The last window step's chunk (B, horizon, action_dim); draws
        are not read (the decode is deterministic)."""
        return self(params, tokens)[:, -1]

    def specs(self, emb_dim: int) -> Dict[str, Tuple[tuple, layers.Init]]:
        return _dense_specs("mean_proj", emb_dim,
                            self.action_horizon * self.action_dim)


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

    def __call__(self, params: Dict[str, torch.Tensor], tokens):
        """tokens (B, window, n, emb), n = horizon with token_per_horizon
        else 1 -> (arm (B, window, horizon, action_dim - 1),
        gripper_logits (B, window, horizon, 1))."""
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

    def predict_action(self, params, tokens, draws=None):
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

    def __init__(self, action_horizon: int, action_dim: int,
                 token_per: str = "action_dim_and_action_horizon",
                 vocab_size: int = 256, normalization_type: str = "uniform"):
        layouts = {"": 1, "action_horizon": action_horizon,
                   "action_dim_and_action_horizon":
                       action_horizon * action_dim}
        if token_per not in layouts:
            raise ValueError(f"Invalid token_per: {token_per}")
        self.action_horizon = action_horizon
        self.action_dim = action_dim
        self.vocab_size = vocab_size
        self.n_tokens = layouts[token_per]
        self.final_layer_size = (action_horizon * action_dim
                                 * vocab_size) // self.n_tokens
        self.tokenizer = BinTokenizer(normalization_type, vocab_size)

    def __call__(self, params: Dict[str, torch.Tensor], tokens):
        """tokens (B, window, n_tokens, emb) -> logits (B, window, horizon,
        action_dim, vocab)."""
        if tokens.shape[2] != self.n_tokens:
            raise ValueError(f"discrete head expects {self.n_tokens} tokens, "
                             f"got {tokens.shape[2]}")
        logits = _head(params, "vocab_proj", tokens.flatten(1, 2))
        return logits.reshape(*tokens.shape[:2], self.action_horizon,
                              self.action_dim, self.vocab_size)

    def loss(self, params: Dict[str, torch.Tensor], tokens, actions,
             timestep_pad_mask, action_pad_mask, draws=None):
        """Per-sample loss (B,) and metrics {"loss", "mse", "accuracy"},
        the mse times action_dim."""
        loss, metrics = discrete_loss(
            self.tokenizer, self(params, tokens), actions,
            chunk_mask(timestep_pad_mask, action_pad_mask))
        metrics["mse"] = metrics["mse"] * self.action_dim
        return loss, metrics

    def predict_action(self, params, tokens, draws=None):
        """The last window step's chunk (B, horizon, action_dim): each
        argmax token's bin centre (the JAX BaseNetwork asks for argmax, so
        draws are not read)."""
        logits = self(params, tokens)[:, -1]
        return self.tokenizer.decode(logits.argmax(-1))

    def specs(self, emb_dim: int) -> Dict[str, Tuple[tuple, layers.Init]]:
        return _dense_specs("vocab_proj", emb_dim, self.final_layer_size)


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

    def __init__(self, action_horizon: int, action_dim: int,
                 max_action: float = 5.0, loss_type: str = "mse",
                 hidden_dim: int = 256, num_blocks: int = 3,
                 time_dim: int = 32, use_layer_norm: bool = True,
                 dropout_rate: float = 0.0, diffusion_steps: int = 20,
                 n_diffusion_samples: int = 1):
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
        """The predicted noise: tokens (B, window, n, emb) mean-pooled,
        time (B, ..., window, 1), noisy_actions (B, ..., window, flat)."""
        emb = tokens.mean(-2)
        if time.dim() > emb.dim():
            emb = emb[:, None].expand(*time.shape[:-1], emb.shape[-1])
        return self.model(params, emb, noisy_actions, time, draws)

    def loss(self, params: Dict[str, torch.Tensor], tokens, actions,
             timestep_pad_mask, action_pad_mask,
             draws: Optional[Draws] = None):
        """Per-sample eps-prediction loss (B,) and metrics {"loss",
        "mse"}, each times action_dim. draws give each sample's steps and
        noise (and the score network's dropout)."""
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
        loss, metrics = continuous_loss(pred, noise, mask, self.loss_type)
        return loss * self.action_dim, {k: v * self.action_dim
                                        for k, v in metrics.items()}

    def predict_action(self, params, tokens, draws: Optional[Draws] = None,
                       embodiment_action_dim: Optional[int] = None):
        """The last window step's sampled chunk (B, horizon, action_dim),
        by the reverse process from x_T ~ N(0, 1), each step's result
        clipped to +-max_action; dims past embodiment_action_dim are set to
        the step's noise level times its draw (without
        embodiment_action_dim every dim is sampled, and the first call
        warns)."""
        if draws is None:
            raise ValueError("the diffusion head samples its actions: pass "
                             "rng (a torch.Generator or Draws)")
        batch, window = tokens.shape[:2]
        dev = tokens.device
        key = str(dev)
        if key not in self._coefficients:
            self._coefficients[key] = self.schedule.reverse_coefficients(dev)
        eps_coef, sqrt_alpha, sqrt_beta, noise_level = self._coefficients[key]
        mask = None
        if embodiment_action_dim is not None:
            mask = embodiment_mask((batch, window), self.action_horizon,
                                   self.action_dim, embodiment_action_dim,
                                   dev).reshape(batch, window, self.flat_dim)
        elif not self._warned:  # the JAX head warns once, when it traces
            self._warned = True
            logging.warning(
                "embodiment_action_dim is recommended for the diffusion "
                "head if any action dimensions were masked during training")
        emb = tokens.mean(-2)
        x = draws.normal("action_head/x_T", (batch, window, self.flat_dim),
                         dev)
        for t in range(self.schedule.num_steps - 1, -1, -1):
            time = torch.full((batch, window, 1), float(t), device=dev)
            eps = self.model(params, emb, x, time)
            x = (x - eps_coef[t] * eps) / sqrt_alpha[t]
            z = draws.normal(f"action_head/z/{t}", x.shape, dev)
            if t > 0:
                x = x + sqrt_beta[t] * z
            x = torch.clamp(x, -self.max_action, self.max_action)
            if mask is not None:
                x = torch.where(mask, x, noise_level[t] * z)
        actions = x.reshape(batch, window, self.action_horizon,
                            self.action_dim)
        return actions[:, -1]

    def specs(self, emb_dim: int) -> Dict[str, Tuple[tuple, layers.Init]]:
        return self.model.specs(emb_dim)
