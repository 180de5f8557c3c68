"""The random draws of a training forward: dropout keep masks and the
trunk's embedding noise, each drawn at a named site.

A `Draws` either generates each draw from one torch.Generator, in the order
the forward asks for them, or replays the draws it was given by site (the
CPU tests feed the JAX package's draws in this way). The train step makes
its generator from the state's (seed, step) (`draws_generator`), so a run
repeats bit for bit, a resumed run draws what the uninterrupted one would
have, and every micro-step of gradient accumulation draws its own. No
module calls the global RNG, and a forward given no Draws (serving,
create_tasks, validation: flax's deterministic=not train) draws nothing.

Sites are named by the module path of the JAX package's draw where that
path is fixed: "context_encoder/encoderblock_0/MlpBlock_0/Dropout_1",
"context_encoder/encoderblock_0/MultiHeadAttention_0" (the attention
weights), "encoder/Dropout_0" (the policy ViT's tokens),
"encoder/Transformer_0/encoderblock_0/Dropout_0"; and by the config key
where flax numbers the module by what else the config builds:
"image_dropout", "embedding_dropout", "final_dropout/<group>" (one per
context-token group, in group order) and "embedding_noise". The diffusion
action head draws its steps and noise at "action_head/time" and
"action_head/noise" (per sample, from the JAX head's make_rng("dropout")),
its score network's dropout at
"action_head/diffusion_model/trunk/blocks/<i>/Dropout_0" (one site a
scanned block), and, sampling, "action_head/x_T" and "action_head/z/<t>"
(models/action_heads.py::DiffusionActionHead); the U-Net DDPM head at
the same sites, and the discrete head, sampling, "action_head/gumbel".
The Octo topology's modules draw at their own paths
("octo_transformer/BlockTransformer_0/Transformer_0/...").

Serving draws only on the diffusion head: the caller's rng, a
torch.Generator (`as_draws` wraps it) or a Draws to replay.
"""
from typing import Dict, Optional

import numpy as np
import torch

#: the stream of `draws_generator`, apart from the device augmentation's
#: (train/train_step.py::augment_generator)
STREAM = 2


def draws_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of a training step's draws: one stream for each
    (seed, step)."""
    words = np.random.SeedSequence([int(seed), int(step), STREAM]
                                   ).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    return gen.manual_seed((int(words[0]) << 32 | int(words[1])) >> 1)


class Draws:
    """Draws by site, generated from `generator` or replayed from
    `replay` ({site: array}, a site missing there raises KeyError). With
    record, every draw is kept in `drawn` ({site: tensor}). rows, (first,
    last, total) of a rank's rows of a global batch
    (parallel/mesh.py::batch_rows), makes each generated draw at the global
    batch's shape and keeps the rank's rows of it, so that the ranks of a
    mesh draw together what one process draws for the whole batch."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 replay: Optional[Dict[str, object]] = None,
                 record: bool = False, rows: Optional[tuple] = None):
        if (generator is None) == (replay is None):
            raise ValueError("give Draws a generator or the draws to replay")
        self.generator = generator
        self.replay = replay
        self.record = record
        self.rows = rows
        self.drawn: Dict[str, torch.Tensor] = {}

    def _take(self, site: str, shape, device, draw):
        if self.replay is not None:
            if site not in self.replay:
                raise KeyError(f"no draw to replay at {site}")
            value = torch.as_tensor(np.array(self.replay[site]),
                                    device=device)
            if tuple(value.shape) != tuple(shape):
                raise ValueError(f"{site}: replayed draw of shape "
                                 f"{tuple(value.shape)}, the forward's "
                                 f"{tuple(shape)}")
        elif self.rows is not None:
            first, last, total = self.rows
            if shape[0] != last - first:
                raise ValueError(f"{site}: a draw of {shape[0]} rows on a "
                                 f"rank that holds {last - first} of the "
                                 "batch")
            value = draw((total,) + tuple(shape[1:]))[first:last]
        else:
            value = draw(shape)
        if self.record:
            if site in self.drawn:
                raise ValueError(f"{site} drawn twice in one forward")
            self.drawn[site] = value
        return value

    def keep_mask(self, site: str, shape, keep: float, device):
        """A bool mask, each element True with probability `keep` (the
        draw of jax.random.bernoulli)."""
        return self._take(site, shape, device, lambda s: torch.rand(
            s, generator=self.generator, device=device) < keep).bool()

    def normal(self, site: str, shape, device):
        """Standard-normal fp32 draws."""
        return self._take(site, shape, device, lambda s: torch.randn(
            s, generator=self.generator, device=device)).float()

    def gumbel(self, site: str, shape, device):
        """Standard Gumbel fp32 draws, -log(-log(u)) of u uniform on
        [tiny, 1) (jax.random.gumbel's form)."""
        tiny = torch.finfo(torch.float32).tiny
        return self._take(site, shape, device, lambda s: -torch.log(
            -torch.log(torch.rand(s, generator=self.generator,
                                  device=device).clamp_(min=tiny)))).float()

    def randint(self, site: str, shape, low: int, high: int, device):
        """Integers drawn uniformly from [low, high)."""
        return self._take(site, shape, device, lambda s: torch.randint(
            low, high, s, generator=self.generator, device=device)
        ).long()


class InvalidRngError(Exception):
    """A module asked for draws of a stream its caller did not give (flax's
    InvalidRngError of the same name, which the JAX package raises)."""


def as_draws(rng) -> Optional[Draws]:
    """A serving call's rng as a Draws: None stays None, a Draws is itself,
    a torch.Generator is drawn from in order."""
    if rng is None or isinstance(rng, Draws):
        return rng
    if isinstance(rng, torch.Generator):
        return Draws(rng)
    raise TypeError(f"rng must be a torch.Generator or a Draws, not "
                    f"{type(rng).__name__}")


def dropout(x, rate: float, draws: Optional[Draws], site: str):
    """flax's nn.Dropout: the identity without draws or at rate 0, else
    x / (1 - rate) where the keep mask (shaped like x) holds and 0 where it
    does not."""
    if draws is None or not rate:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    mask = draws.keep_mask(site, x.shape, keep, x.device)
    return torch.where(mask, x / keep, torch.zeros_like(x))


def attention_dropout(weights, rate: float, draws: Optional[Draws],
                      site: str):
    """The attention-weight dropout of hypervla_tpu/models/attention.py:
    weights * keep / (1 - rate)."""
    if draws is None or not rate:
        return weights
    mask = draws.keep_mask(site, weights.shape, 1.0 - rate, weights.device)
    return weights * mask / (1.0 - rate)
