"""The regularised training step on the card, on the tiny model with a
bf16 DINOv2 trunk of head dim 64 (`dinov2-test-wide`, the fused training
attention's shape), the trunk fine-tuned through kernel 2
(ops/fused_attention.py): with every dropout rate and the embedding noise
at 0.1, a step repeats bit for bit from one state and (seed, step), and
another step draws other masks, each kept at its rate; each layer remat
setting gives the gradients of the step without remat bit for bit, with
kernel 2's forward launched again in the recompute.

Skips where there is no CUDA device. On a GPU host without JAX, skip the
JAX-only conftest: `python -m pytest --noconftest -q
tests/test_torch_regularised_cuda.py`.
"""
import pytest
import torch

from hypervla_tpu_torch.configs import (
    apply_fast_training_preset,
    tiny_test_config,
)
from hypervla_tpu_torch.flagship import make_flagship_batch
from hypervla_tpu_torch.models.draws import Draws, draws_generator
from hypervla_tpu_torch.models.hypervla import HyperVLA
from hypervla_tpu_torch.ops import fused_attention as fa
from hypervla_tpu_torch.train import optimizer as topt
from hypervla_tpu_torch.train.train_state import TrainState
from hypervla_tpu_torch.train.train_step import make_train_step
from test_torch_harness import torch_threads  # noqa: F401

pytestmark = pytest.mark.cuda

RATE = 0.1
REMAT = {"remat_dino": {"remat_dino": True},
         "nothing": {"dino_remat_policy": "nothing"},
         "dots": {"dino_remat_policy": "dots"},
         "dots_no_batch": {"dino_remat_policy": "dots_no_batch"}}


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _config(**vit):
    config = apply_fast_training_preset(tiny_test_config())
    config["base_net_kwargs"]["vit_kwargs"].update(
        pretrained_encoder_name="dinov2-test-wide",
        fine_tune_pretrained_image_encoder=True, dropout_rate=RATE,
        image_embedding_noise=RATE, **vit)
    hk = config["hypernet_kwargs"]
    hk.update(image_dropout=RATE, embedding_dropout_rate=RATE,
              final_dropout_rate=RATE)
    hk["context_encoder_kwargs"].update(dropout_rate=RATE,
                                        attention_dropout_rate=RATE)
    return config


def _batch():
    return make_flagship_batch(batch_size=4, instr_len=8, action_horizon=2,
                               initial_patch_dim=128)


@pytest.fixture(scope="module")
def model(device):
    return HyperVLA.from_config(_config(), _batch(), device=device)


def _step(model, config, step=5, draws=None):
    """(new params, gradients) of one step at `step`."""
    tx, lr_fn, base_lr_fn, pnorm_fn = topt.create_optimizer(
        model.params, topt.hn_param_type_tree(model.params),
        **config["optimizer"])
    variant = HyperVLA.from_config(config, _batch(), device=model.device)
    variant.params = model.params
    fn = make_train_step(variant, config, tx, lr_fn, base_lr_fn, pnorm_fn)
    state = TrainState.create(model.params, tx, seed=3)
    # the update count drives the LR schedule (at count 0 the LR is 0 and
    # no param moves): set it with the step, as the parity tests do
    state.step = step
    state.opt_state["count"] = step
    new, _ = fn(state, _batch(), with_metrics=False, draws=draws)
    torch.cuda.synchronize()
    return new.params, {k: p.grad.clone() for k, p in state.params.items()
                        if p.grad is not None}


def test_regularised_step_repeats_by_seed_and_step(model):
    config = _config()
    a, _ = _step(model, config)
    b, _ = _step(model, config)
    c, _ = _step(model, config, step=6)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)


def test_kept_fraction_at_the_rate(model):
    draws = Draws(draws_generator(3, 5, model.device), record=True)
    _step(model, _config(), draws=draws)
    masks = {k: v for k, v in draws.drawn.items() if v.dtype == torch.bool}
    assert len(masks) == 14
    for site, mask in masks.items():
        n = mask.numel()
        kept = float(mask.float().mean())
        assert abs(kept - (1 - RATE)) <= 6 * (RATE * (1 - RATE) / n) ** .5, (
            site, kept)


@pytest.mark.parametrize("name", sorted(REMAT))
def test_remat_keeps_the_gradients_on_the_card(model, name):
    _, base = _step(model, _config())
    fa.reset_launch_counts()
    _, got = _step(model, _config(**REMAT[name]))
    # 2 trunk layers: the forward again in the recompute
    assert fa.LAUNCHES["mha_fused_train_fwd"] == 4
    assert fa.LAUNCHES["mha_fused_train_bwd"] == 2
    assert set(got) == set(base)
    for key, value in base.items():
        assert torch.equal(got[key], value), key
