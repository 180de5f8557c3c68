"""The port has no dropout. Each of the six dropout rates the JAX package
reads (hypervla_tpu/models/hypernetwork.py: image_dropout,
embedding_dropout_rate, final_dropout_rate, the context encoder's
dropout_rate and attention_dropout_rate; hypervla_tpu/models/base_vit.py:
the policy ViT's dropout_rate) raises NotImplementedError naming the key
when it is nonzero, from the model's constructor and from the train step;
a rate of 0 or an absent key builds."""
import copy

import pytest

from hypervla_tpu_torch.configs import DROPOUT_KEYS, tiny_test_config
from hypervla_tpu_torch.flagship import make_flagship_batch
from hypervla_tpu_torch.models.hypervla import HyperVLA
from hypervla_tpu_torch.train import optimizer as topt
from hypervla_tpu_torch.train.train_step import make_train_step


def _section(config, name):
    return {
        "hypernet_kwargs": lambda: config["hypernet_kwargs"],
        "hypernet_kwargs context_encoder_kwargs":
            lambda: config["hypernet_kwargs"]["context_encoder_kwargs"],
        "vit_kwargs": lambda: config["base_net_kwargs"]["vit_kwargs"],
    }[name]()


KEYS = [(section, key) for section, keys in DROPOUT_KEYS.items()
        for key in keys]


def _build(config):
    batch = make_flagship_batch(instr_len=8, action_horizon=2,
                                initial_patch_dim=32)
    return HyperVLA.from_config(config, batch, device="cpu")


@pytest.fixture(scope="module")
def model():
    return _build(tiny_test_config())


def test_the_jax_package_reads_six_dropout_rates():
    assert len(KEYS) == 6


@pytest.mark.parametrize("section,key", KEYS)
def test_nonzero_dropout_refused_by_the_constructor(section, key):
    config = tiny_test_config()
    _section(config, section)[key] = 0.1
    with pytest.raises(NotImplementedError, match=key):
        _build(config)


@pytest.mark.parametrize("section,key", KEYS)
def test_nonzero_dropout_refused_by_the_train_step(model, section, key):
    config = copy.deepcopy(model.config)
    _section(config, section)[key] = 0.1
    tx, lr_fn, base_lr_fn, pnorm_fn = topt.create_optimizer(
        model.params, topt.hn_param_type_tree(model.params),
        **config["optimizer"])
    with pytest.raises(NotImplementedError, match=key):
        make_train_step(model, config, tx, lr_fn, base_lr_fn, pnorm_fn)


@pytest.mark.parametrize("section,key", KEYS)
def test_zero_dropout_builds(model, section, key):
    config = tiny_test_config()
    _section(config, section)[key] = 0.0
    built = _build(config)
    assert set(built.params) == set(model.params)
    tx, lr_fn, base_lr_fn, pnorm_fn = topt.create_optimizer(
        built.params, topt.hn_param_type_tree(built.params),
        **config["optimizer"])
    make_train_step(built, config, tx, lr_fn, base_lr_fn, pnorm_fn)
