"""Every field of the JAX package's policy ViT
(hypervla_tpu/models/base_vit.py::ViT) against the port's
(hypervla_tpu_torch/models/base_vit.py::ViT): a config that sets a field
either builds a model that reads it, or raises naming it, or (where the
field only re-lays a computation out for the TPU) builds the same model as
without it. A field that the tables below do not name fails: a switch of
the JAX package must not be taken without a word. Each switch that a slice
lifts from the refused table is also held to the JAX ViT's forward
(`test_lifted_switch_matches_jax`).
"""
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from hypervla_tpu.configs import tiny_test_config as jax_tiny_config
from hypervla_tpu.models.base_vit import ViT as JaxViT
from hypervla_tpu_torch.configs import tiny_test_config
from hypervla_tpu_torch.models.base_vit import ViT, check_trunk_switches
from hypervla_tpu_torch.utils.convert import from_jax_params
from test_torch_harness import torch_threads  # noqa: F401

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
    "use_language_token": (True, {}),
    "include_class_token": (True, {}),
    "add_positional_embedding": (False, {}),
    "patch_size": (32, {"encoder_type": "SmallStem"}),
    "cnn_channels": ((32, 64, 96, 128), {"encoder_type": "SmallStem"}),
    "dropout_rate": (0.1, {}),
    "image_embedding_noise": (0.1, {}),
    "return_attention_map": (True, {}),
    "scan_dino_layers": (True, {"sow_dino_attention": False}),
    "remat_dino": (True, {}),
    "dino_remat_policy": ("dots", {}),
    "encoder_type": ("CLIP", {}),
    "use_differential_transformer": (True, {}),
    "flash_attention_trainable": (True, {"use_flash_attention": True,
                                         "sow_dino_attention": False}),
}

# field -> a non-default value that the constructor refuses
REFUSED = {}

# field -> a non-default value that is accepted and changes nothing:
# dino_dot_softmax re-lays the softmax sums out for the TPU's matrix unit
# (the same values up to rounding)
ACCEPTED = {
    "dino_dot_softmax": True,
}

TABLES = (HONOURED, REFUSED, ACCEPTED)
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
    elif field in ACCEPTED:
        assert _build(**{field: ACCEPTED[field]}) == _build()
    else:
        pytest.fail(f"the JAX ViT's field {field!r} is in no table: the port "
                    "neither honours nor refuses it")


@pytest.mark.parametrize("kwargs,error", [
    (dict(scan_dino_layers=True), AssertionError),
    (dict(dino_remat_policy="everything"), KeyError),
    (dict(dino_fused_add_ln=True, sow_dino_attention=False,
          remat_dino=True), AssertionError),
])
def test_the_trunk_switch_check_keeps_the_jax_refusals(kwargs, error):
    """The combinations the JAX ViT refuses, with its exception types: the
    scanned trunk with attention capture on (its default), an unknown
    remat policy, the fused residual boundaries under remat. The JAX ViT
    is built (initialised on a frame) for each and raises the same type as
    the port's check and the port's ViT."""
    kw = jax_tiny_config("DINOv2")["base_net_kwargs"]["vit_kwargs"]
    kw = dict(kw, pretrained_encoder_name="dinov2-test", **kwargs)
    images = np.zeros((1, 224, 224, 3), np.uint8)
    instruction = np.zeros((1, 5, 12), np.float32)
    with pytest.raises(error):
        JaxViT(**kw, action_token_num=1).init(
            jax.random.PRNGKey(0), images, instruction, train=False)
    with pytest.raises(error):
        check_trunk_switches(_vit_kwargs(**kwargs))
    with pytest.raises(error):
        ViT(_vit_kwargs(**kwargs), 1)


def test_a_dinov2_frame_of_another_size_raises_as_in_jax():
    """The JAX ViT asserts a DINOv2 frame's 224 x 224; the port raises the
    same AssertionError."""
    kw = jax_tiny_config("DINOv2")["base_net_kwargs"]["vit_kwargs"]
    kw = dict(kw, pretrained_encoder_name="dinov2-test")
    images = np.zeros((1, 64, 64, 3), np.uint8)
    instruction = np.zeros((1, 5, 12), np.float32)
    with pytest.raises(AssertionError, match="224x224"):
        JaxViT(**kw, action_token_num=1).init(
            jax.random.PRNGKey(0), images, instruction, train=False)
    vit = ViT(_vit_kwargs(), 1)
    params = {name: torch.zeros(shape)
              for name, (shape, _) in vit.specs().items()}
    with pytest.raises(AssertionError, match="224x224"):
        vit(params, torch.zeros((1, 64, 64, 3), dtype=torch.uint8))


def test_dino_dot_softmax_passes_the_trunk_switch_check():
    check_trunk_switches(_vit_kwargs(dino_dot_softmax=True))


#: the switches lifted from REFUSED (and encoder_type's ported values):
#: field -> (the JAX tiny config's encoder_type, value, frame size[, the
#: other keys it needs]); the serving forward (train=False), where dropout
#: and noise draw nothing (tests/test_torch_dropout.py holds them in
#: training), remat changes no value, the scanned trunk's params arrive
#: stacked and return_attention_map returns the last block's map too
LIFTED = {
    "use_language_token": ("SmallStem", True, 64),
    "add_positional_embedding": ("SmallStem", False, 64),
    "include_class_token": ("DINOv2", True, 224),
    "patch_size": ("SmallStem", 32, 64),
    "cnn_channels": ("SmallStem", (32, 64, 96, 128), 64),
    "encoder_type": ("SmallStem", "PatchEncoder", 64),
    "dropout_rate": ("SmallStem", 0.1, 64),
    "image_embedding_noise": ("DINOv2", 0.1, 224),
    "return_attention_map": ("SmallStem", True, 64),
    "scan_dino_layers": ("DINOv2", True, 224,
                         {"sow_dino_attention": False}),
    "remat_dino": ("DINOv2", True, 224),
    "dino_remat_policy": ("DINOv2", "dots", 224),
    "use_differential_transformer": ("SmallStem", True, 64),
    "flash_attention_trainable": ("DINOv2", True, 224,
                                  {"use_flash_attention": True,
                                   "sow_dino_attention": False}),
}


@pytest.mark.parametrize("field", sorted(LIFTED))
def test_lifted_switch_matches_jax(field):
    """The JAX ViT and the port's with the switch set, on the same params
    (the JAX init, perturbed, through from_jax_params) and inputs: the
    readout embeddings (and with return_attention_map the last block's
    attention map) to 1e-5."""
    encoder, value, size, *others = LIFTED[field]
    kw = jax_tiny_config(encoder)["base_net_kwargs"]["vit_kwargs"]
    kw = dict(kw, **{field: value}, **(others[0] if others else {}))
    if encoder == "DINOv2":
        kw["pretrained_encoder_name"] = "dinov2-test"
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (2, size, size, 3)).astype(np.uint8)
    instruction = rng.randn(2, 5, 12).astype(np.float32)
    jvit = JaxViT(**kw, action_token_num=2)
    # the JAX ViT draws its embedding noise at train=False too (and
    # multiplies it by 0), so it needs the key
    rngs = {"embedding_noise": jax.random.PRNGKey(1)}
    variables = jvit.init({"params": jax.random.PRNGKey(0), **rngs}, images,
                          instruction, train=False)
    variables = jax.tree_util.tree_map(
        lambda v: (v + rng.randn(*v.shape) * 0.05).astype(np.float32),
        variables)
    ref, ref_map = jvit.apply(variables, images, instruction, train=False,
                              rngs=rngs)
    params = {f"encoder/{k}": v for k, v in from_jax_params(
        jax.tree_util.tree_map(np.asarray, variables["params"])).items()}
    vit = ViT(kw, 2, {"image": (size, size), "instruction": (5, 12)})
    assert set(params) == set(vit.specs())
    for name, (shape, _) in vit.specs().items():
        assert tuple(params[name].shape) == tuple(shape), name
    maps = {}
    got = vit(params, torch.tensor(images),
              instruction_embeddings=torch.tensor(instruction), maps=maps)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    if kw.get("return_attention_map"):
        np.testing.assert_allclose(maps["policy"][-1].numpy(),
                                   np.asarray(ref_map), rtol=1e-5,
                                   atol=1e-6)
