"""Every field of the JAX package's policy ViT
(hypervla_tpu/models/base_vit.py::ViT) against the port's
(hypervla_tpu_torch/models/base_vit.py::ViT): a config that sets a field
either builds a model that reads it, or raises naming it, or (where the
field only re-lays a computation out for the TPU, or belongs to an encoder
the port refuses) builds the same model as without it. A field that the
tables below do not name fails: a switch of the JAX package must not be
taken without a word.
"""
import copy
import dataclasses

import pytest

from hypervla_tpu.models.base_vit import ViT as JaxViT
from hypervla_tpu_torch.configs import tiny_test_config
from hypervla_tpu_torch.models.base_vit import ViT, check_trunk_switches
from hypervla_tpu_torch.train.train_step import _unported

# flax's own bookkeeping fields of every nn.Module
FLAX_FIELDS = ("parent", "name")

# field -> (a non-default value, the other keys that let it show): the
# port's ViT built with the value differs from the one built without
HONOURED = {
    "hidden_dim": (32, {}),
    "num_layers": (3, {}),
    "num_heads": (8, {}),
    "mlp_dim": (64, {}),
    "action_token_num": (3, {}),
    "fine_tune_pretrained_image_encoder": (True, {}),
    "pretrained_encoder_name": ("dinov2-test-wide", {}),
    "encoder_dtype": ("bfloat16", {}),
    "use_flash_attention": (True, {"sow_dino_attention": False}),
    "sow_dino_attention": (False, {"use_flash_attention": True}),
    "fused_layer_norm": (True, {}),
    "dino_layers_impl": ("pallas_train", {"encoder_dtype": "bfloat16"}),
    "dino_fused_attention": (True, {"sow_dino_attention": False}),
    "dino_fused_add_ln": (True, {"sow_dino_attention": False}),
}

# field -> a non-default value that the constructor refuses
REFUSED = {
    "encoder_type": "CLIP",
    "dropout_rate": 0.1,
    "use_language_token": True,
    "use_differential_transformer": True,
    "return_attention_map": True,
    "add_positional_embedding": False,
    "include_class_token": True,
    "flash_attention_trainable": True,
    "scan_dino_layers": True,
    "remat_dino": True,
    "dino_remat_policy": "dots",
}

# field -> a non-default value that only the train step refuses (the JAX
# package adds the noise only in training; serving never reads it)
REFUSED_BY_THE_TRAIN_STEP = {"image_embedding_noise": 0.1}

# field -> a non-default value that is accepted and changes nothing:
# patch_size and cnn_channels belong to the SmallStem and patchify encoders
# (DINOv2 takes its patch size from the encoder's config);
# dino_dot_softmax re-lays the softmax sums out for the TPU's matrix unit
# (the same values up to rounding)
ACCEPTED = {
    "patch_size": 8,
    "cnn_channels": (8, 16),
    "dino_dot_softmax": True,
}

TABLES = (HONOURED, REFUSED, REFUSED_BY_THE_TRAIN_STEP, ACCEPTED)
JAX_FIELDS = [f.name for f in dataclasses.fields(JaxViT)
              if f.name not in FLAX_FIELDS]


def _vit_kwargs(**changes):
    kw = copy.deepcopy(tiny_test_config()["base_net_kwargs"]["vit_kwargs"])
    kw.update(changes)
    return kw


def _build(**changes):
    tokens = changes.pop("action_token_num", 1)
    return vars(ViT(_vit_kwargs(**changes), tokens))


def test_the_tables_name_jax_fields_only_and_each_once():
    named = [name for table in TABLES for name in table]
    assert len(named) == len(set(named))
    assert set(named) <= set(JAX_FIELDS)


def test_the_non_default_values_differ_from_the_jax_defaults():
    defaults = {f.name: f.default for f in dataclasses.fields(JaxViT)}
    for table in TABLES:
        for name, value in table.items():
            value = value[0] if table is HONOURED else value
            assert value != defaults[name], name


@pytest.mark.parametrize("field", JAX_FIELDS)
def test_every_jax_vit_field_is_honoured_or_refused(field):
    if field in HONOURED:
        value, others = HONOURED[field]
        assert _build(**others, **{field: value}) != _build(**others)
    elif field in REFUSED:
        with pytest.raises((NotImplementedError, ValueError), match=field):
            _build(**{field: REFUSED[field]})
    elif field in REFUSED_BY_THE_TRAIN_STEP:
        config = tiny_test_config()
        config["base_net_kwargs"]["vit_kwargs"][field] = (
            REFUSED_BY_THE_TRAIN_STEP[field])
        with pytest.raises(NotImplementedError, match=field):
            _unported(config, None)
    elif field in ACCEPTED:
        assert _build(**{field: ACCEPTED[field]}) == _build()
    else:
        pytest.fail(f"the JAX ViT's field {field!r} is in no table: the port "
                    "neither honours nor refuses it")


@pytest.mark.parametrize("field", ["scan_dino_layers", "remat_dino",
                                   "dino_remat_policy"])
def test_the_trunk_switch_check_refuses_naming_the_key(field):
    """The check the train step shares with the constructor."""
    with pytest.raises(NotImplementedError, match=field):
        check_trunk_switches(_vit_kwargs(**{field: REFUSED[field]}))
    default = {f.name: f.default for f in dataclasses.fields(JaxViT)}[field]
    check_trunk_switches(_vit_kwargs(**{field: default}))


def test_dino_dot_softmax_passes_the_trunk_switch_check():
    check_trunk_switches(_vit_kwargs(dino_dot_softmax=True))


def test_from_jax_params_refuses_a_scanned_trunk():
    import numpy as np

    from hypervla_tpu_torch.utils.convert import from_jax_params

    leaf = np.zeros((2, 4, 4), np.float32)
    plain = {"encoder": {"image_encoder": {"encoder": {
        "layer_0": {"mlp": {"fc1": {"kernel": leaf[0]}}}}}}}
    assert len(from_jax_params(plain, device="cpu")) == 1
    scanned = {"encoder": {"image_encoder": {"encoder": {"layers": {
        "layer": {"mlp": {"fc1": {"kernel": leaf}}}}}}}}
    with pytest.raises(NotImplementedError, match="scan_dino_layers"):
        from_jax_params(scanned, device="cpu")
