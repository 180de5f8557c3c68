"""The v4 weight decay of the port's train step against the JAX package's
make_train_step (helpers, fixture and tolerances:
tests/test_torch_weight_decay_steps.py): the clipped gradient of 0.5 *
sum(kernel ** 2) over the generated base-net params, averaged over the
batch, times lr * auxiliary_loss base_weight_decay, subtracted from the
updates; its logged norm to 1e-5. A v4 config without
auxiliary_loss.base_weight_decay fails in both packages."""
import copy

import numpy as np
import pytest

from hypervla_tpu_torch.train import optimizer as topt
from test_torch_harness import torch_threads  # noqa: F401
from test_torch_weight_decay_steps import (  # noqa: F401
    STEP0,
    _assert_steps_agree,
    _assert_terms_agree,
    _jax_step,
    _torch_step,
    models,
)

#: auxiliary_loss base_weight_decay: large, so that the term stands well
#: above the rounding of the params it is subtracted from
COEF = 100.0


def test_v4_weight_decay_matches_jax(models):
    jmodel, model = models
    config = copy.deepcopy(jmodel.config)
    config["optimizer"]["weight_decay_strategy"] = "v4"
    config["auxiliary_loss"]["base_weight_decay"] = COEF
    # one optimizer for both steps (v4's mask is v1's) isolates the term
    off = copy.deepcopy(config)
    off["optimizer"]["weight_decay_strategy"] = "v1"
    old = {k: v.numpy() for k, v in model.params.items()}
    ref, ref_info = _jax_step(jmodel, config, config)
    ref_off, _ = _jax_step(jmodel, config, off)
    got, got_info = _torch_step(model, config, config)
    got_off, _ = _torch_step(model, config, off)
    np.testing.assert_allclose(got_info["base_weight_decay_grad_norm"],
                               ref_info["base_weight_decay_grad_norm"],
                               rtol=1e-5)
    clip = config["optimizer"]["clip_gradient"]
    assert got_info["base_weight_decay_grad_norm"] > clip  # clipped
    _assert_steps_agree(old, got, ref, got_info, ref_info)
    # the term reaches the generated kernels' output heads, the context
    # encoder and the projections
    assert _assert_terms_agree(got, got_off, ref, ref_off) > 20
    # its norm: lr * base_weight_decay * min(norm, clip)
    delta = np.sqrt(sum(((got[k].astype(np.float64) - got_off[k]) ** 2
                         ).sum() for k in got))
    lr = topt.create_lr_schedule(**config["optimizer"]["learning_rate"])(
        STEP0)
    np.testing.assert_allclose(delta, lr * COEF * clip, rtol=5e-4)


def test_v4_without_its_coefficient_fails_in_both(models):
    jmodel, model = models
    config = copy.deepcopy(jmodel.config)
    config["optimizer"]["weight_decay_strategy"] = "v4"
    config["auxiliary_loss"].pop("base_weight_decay", None)
    with pytest.raises(KeyError, match="base_weight_decay"):
        _jax_step(jmodel, config, config)
    with pytest.raises(KeyError, match="auxiliary_loss.base_weight_decay"):
        _torch_step(model, config, config)
