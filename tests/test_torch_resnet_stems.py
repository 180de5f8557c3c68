"""The ResNet stems and the in-model T5 of the Octo topology's tokenizers
against the JAX package, on the same numpy inputs and the JAX params
carried across, in fp32 to 1e-5:

  * normalize_images "imagenet" over one and two stacked frames (and a
    channel count that is no multiple of 3: AssertionError in both);
  * flax's max_pool with "SAME" padding (-inf, the odd pixel on the high
    side);
  * ResidualUnit with and without its projected shortcut, and ViTResnet as
    the registry's resnetv2-26-film and resnetv2-50-film, FiLM-conditioned
    after every stage but the first, over ImageNet-normalized frames;
  * an ImageTokenizer on the resnetv2-26-film encoder with its FiLM on a
    task key;
  * the LanguageTokenizer with its in-model T5 ("t5-base" swapped for a
    two-layer T5 in both packages for the test): token ids through the T5
    under hf_model, its weights from load_t5_weights where a file is
    there, finetune_encoder's gradient.
"""
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervla_tpu.models import tokenizers as jtok
from hypervla_tpu.models import vit_encoders as jvit
from hypervla_tpu.models.encoders import t5 as jt5
from hypervla_tpu.utils.spec import ModuleSpec as JaxSpec
from hypervla_tpu_torch.models import tokenizers as tok
from hypervla_tpu_torch.models import vit_encoders as vit
from hypervla_tpu_torch.models.encoders import t5
from hypervla_tpu_torch.utils.convert import from_jax_params
from hypervla_tpu_torch.utils.spec import ModuleSpec
from test_torch_harness import torch_threads  # noqa: F401
from test_torch_octo_layers import _assert_specs, _perturbed, _torch_tree

TOL = dict(rtol=1e-5, atol=1e-5)


def _ported(params, prefix):
    return {f"{prefix}/{k}": v for k, v in from_jax_params(params).items()}


@pytest.mark.parametrize("frames", [1, 2])
def test_imagenet_normalization_matches_jax(frames):
    img = np.random.default_rng(frames).integers(
        0, 256, (2, 5, 7, 3 * frames), dtype=np.uint8)
    want = jvit.normalize_images(img, "imagenet")
    got = vit.normalize_images(torch.tensor(img), "imagenet")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    bad = np.concatenate([img, img[..., :1]], -1)
    for fn, x in ((jvit.normalize_images, bad),
                  (vit.normalize_images, torch.tensor(bad))):
        with pytest.raises(AssertionError, match="rgb"):
            fn(x, "imagenet")
    with pytest.raises(ValueError, match="unknown"):
        vit.normalize_images(torch.tensor(img), "other")


@pytest.mark.parametrize("size", [7, 8])
def test_max_pool_same_matches_flax(size):
    x = np.random.default_rng(size).standard_normal(
        (2, size, size, 3)).astype(np.float32) - 4.0
    want = flax.linen.max_pool(jnp.asarray(x), (3, 3), (2, 2), "SAME")
    got = vit.max_pool_same(torch.tensor(x).permute(0, 3, 1, 2), 3, 2)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("features,strides,c_in", [(32, (1, 1), 128),
                                                   (32, (2, 2), 64),
                                                   (32, (1, 1), 32)])
def test_residual_unit_matches_jax(features, strides, c_in):
    x = np.random.default_rng(c_in).standard_normal(
        (2, 9, 9, c_in)).astype(np.float32)
    ref = jvit.ResidualUnit(features, strides=strides)
    variables = _perturbed(ref.init(jax.random.PRNGKey(0), x), scale=0.1)
    want = ref.apply(variables, x)
    params = _ported(variables["params"], "u")
    unit = vit.ResidualUnit(features, strides)
    _assert_specs(unit.specs("u", c_in), params)
    got = unit(params, "u", torch.tensor(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("name,size,channels", [
    ("resnetv2-26-film", 37, 6), ("resnetv2-50-film", 17, 3)])
def test_resnet_stems_match_jax(name, size, channels):
    rng = np.random.default_rng(size)
    images = rng.integers(0, 256, (2, size, size, channels), dtype=np.uint8)
    cond = rng.standard_normal((2, 5)).astype(np.float32)
    ref = jvit.vit_encoder_configs[name](img_norm_type="imagenet")
    variables = _perturbed(jax.jit(ref.init)(jax.random.PRNGKey(0), images,
                                             cond_var=cond), scale=0.1)
    want = np.asarray(jax.jit(ref.apply)(variables, images, cond_var=cond))
    got_stem = vit.vit_encoder_configs[name](img_norm_type="imagenet")
    params = _ported(variables["params"], "s")
    _assert_specs(got_stem.specs("s", channels, 5), params)
    got = got_stem(params, "s", torch.tensor(images),
                   cond_var=torch.tensor(cond))
    assert got.shape[1] == got_stem.num_tokens(size, size)
    assert got.shape[-1] == got_stem.num_features == want.shape[-1]
    np.testing.assert_allclose(got.numpy(), want.reshape(got.shape), **TOL)
    assert vit.ResNet26FILM().num_layers == jvit.ResNet26FILM().num_layers
    assert sorted(vit.vit_encoder_configs) == sorted(jvit.vit_encoder_configs)


def test_resnet_image_tokenizer_matches_jax():
    """An ImageTokenizer over resnetv2-26-film, the goal stacked on the
    frame, FiLM on a task key, ImageNet-normalized."""
    rng = np.random.default_rng(5)
    obs = {"image_primary": rng.integers(0, 256, (2, 2, 32, 32, 3),
                                         dtype=np.uint8),
           "timestep_pad_mask": np.ones((2, 2), bool)}
    task = {"image_primary": rng.integers(0, 256, (2, 32, 32, 3),
                                          dtype=np.uint8),
            "language_embedding": rng.standard_normal((2, 6)).astype(
                np.float32),
            "pad_mask_dict": {"image_primary": np.ones(2, bool)}}
    kwargs = dict(obs_stack_keys=["image_primary"],
                  task_stack_keys=["image_primary"],
                  task_film_keys=["language_embedding"])
    ref = jtok.ImageTokenizer(encoder=JaxSpec.create(
        jvit.ResNet26FILM, img_norm_type="imagenet"), **kwargs)
    variables = _perturbed(jax.jit(ref.init)(jax.random.PRNGKey(0), obs,
                                             task), scale=0.1)
    want = jax.jit(ref.apply)(variables, obs, task)
    got_tok = tok.ImageTokenizer(encoder=ModuleSpec.create(
        vit.ResNet26FILM, img_norm_type="imagenet"), **kwargs)
    params = _ported(variables["params"], "t")
    _assert_specs(got_tok.specs("t", obs, task), params)
    got = got_tok(params, "t", _torch_tree(obs), _torch_tree(task))
    np.testing.assert_allclose(got.tokens.numpy(), np.asarray(want.tokens),
                               **TOL)


# --------------------------- the in-model T5 ---------------------------


TINY_T5 = dict(vocab_size=64, d_model=16, d_kv=8, d_ff=32, num_layers=2,
               num_heads=2)


@pytest.fixture
def tiny_t5(monkeypatch):
    monkeypatch.setitem(jt5._NAMED_CONFIGS, "t5-base",
                        jt5.T5Config(**TINY_T5))
    monkeypatch.setitem(t5._NAMED_CONFIGS, "t5-base", t5.T5Config(**TINY_T5))


def _language_task(seed=0):
    rng = np.random.default_rng(seed)
    mask = np.ones((2, 6), np.int32)
    mask[1, 4:] = 0
    return {"language_instruction": {
                "input_ids": rng.integers(0, 64, (2, 6)).astype(np.int32),
                "attention_mask": mask},
            "pad_mask_dict": {"language_instruction": np.array([True,
                                                                False])}}


@pytest.mark.parametrize("finetune", [False, True])
def test_language_tokenizer_t5_matches_jax(tiny_t5, finetune):
    task = _language_task()
    ref = jtok.LanguageTokenizer(encoder="t5-base", finetune_encoder=finetune)
    variables = _perturbed(ref.init(jax.random.PRNGKey(0), {}, task),
                           scale=0.05)
    want = ref.apply(variables, {}, task)
    got_tok = tok.LanguageTokenizer(encoder="t5-base",
                                    finetune_encoder=finetune)
    params = _ported(variables["params"], "lang")
    _assert_specs(got_tok.specs("lang"), params)
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    got = got_tok(params, "lang", {}, _torch_tree(task))
    np.testing.assert_allclose(got.tokens.detach().numpy(),
                               np.asarray(want.tokens), **TOL)
    np.testing.assert_array_equal(got.mask.numpy(),
                                  np.asarray(want.mask).astype(bool))
    assert got.tokens.requires_grad == finetune
    # and its gradient with finetune_encoder, against JAX's
    if finetune:
        def loss(p):
            return (ref.apply({"params": p}, {}, task).tokens ** 2).sum()

        jgrads = from_jax_params(jax.grad(loss)(variables["params"]))
        (got.tokens ** 2).sum().backward()
        for name, value in jgrads.items():
            np.testing.assert_allclose(params[f"lang/{name}"].grad.numpy(),
                                       value.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=name)


def test_language_tokenizer_loads_the_pretrained_t5(tiny_t5, tmp_path,
                                                    monkeypatch):
    got_tok = tok.LanguageTokenizer(encoder="t5-base")
    specs = got_tok.specs("lang")
    params = {k: torch.zeros(s) for k, (s, _) in specs.items()}
    monkeypatch.setenv("HYPERVLA_PRETRAINED_DIR", str(tmp_path))
    assert got_tok.load_weights(params, "lang") is params  # no file
    weights = {k: init(s, torch.Generator().manual_seed(0))
               for k, (s, init) in t5.t5_specs(t5.t5_config("t5-base")).items()}
    torch.save(weights, os.path.join(tmp_path, "t5-base.pt"))
    loaded = got_tok.load_weights(params, "lang")
    for key, value in weights.items():
        assert torch.equal(loaded[f"lang/hf_model/{key}"], value)
    assert tok.LanguageTokenizer().specs("lang") == {}
