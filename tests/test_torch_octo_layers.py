"""The Octo topology's layers in the port against the JAX package's on the
CPU, fp32, on the same params (the JAX init, perturbed, through
utils/convert.py::from_jax_params) and inputs, each to 1e-5: the
BlockTransformer's masks (element for element, use_correct_attention
either way), its causality check and its forward split into groups; the
MAP head; FiLM; the stems with FiLM, SmallStem16 and the named variants;
the ImageTokenizer (goal images stacked, FiLM on a task key, a
TokenLearner, the pad masks), the LanguageTokenizer and the
LowdimObsTokenizer (discretized).
"""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypervla_tpu.models import block_transformer as jbt
from hypervla_tpu.models import tokenizers as jtok
from hypervla_tpu.models import vit_encoders as jvit
from hypervla_tpu.models.film import FilmConditioning as JaxFilm
from hypervla_tpu.models.transformer import MAPHead as JaxMAPHead
from hypervla_tpu.utils.spec import ModuleSpec as JaxSpec
from hypervla_tpu_torch.models import block_transformer as bt
from hypervla_tpu_torch.models import tokenizers as tok
from hypervla_tpu_torch.models import vit_encoders as vit
from hypervla_tpu_torch.models.film import film_conditioning, film_specs
from hypervla_tpu_torch.models.token_group import TokenGroup
from hypervla_tpu_torch.models.transformer import map_head, map_head_specs
from hypervla_tpu_torch.utils.convert import (
    from_jax_params,
    port_module_specs,
)
from hypervla_tpu_torch.utils.spec import ModuleSpec
from test_torch_harness import torch_threads  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
KWARGS = dict(num_layers=2, mlp_dim=32, num_attention_heads=2,
              dropout_rate=0.0, attention_dropout_rate=0.0)
D = 16


def _perturbed(tree, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + rng.standard_normal(np.shape(v))
                   * scale).astype(np.float32), flax.core.unfreeze(tree))


def _ported(params, prefix):
    return {f"{prefix}/{k}": v for k, v in from_jax_params(params).items()}


def _assert_specs(specs, params):
    assert set(specs) == set(params), (sorted(set(specs) ^ set(params))[:6])
    for name, (shape, _) in specs.items():
        assert tuple(params[name].shape) == tuple(shape), name


# ------------------------------ the groups ------------------------------


def _groups(pkg, batch=2, horizon=3, pad=False, seed=0):
    rng = np.random.default_rng(seed)
    asarray = jnp.asarray if pkg is jbt else torch.tensor
    task = rng.standard_normal((batch, 2, D)).astype(np.float32)
    obs = rng.standard_normal((batch, horizon, 4, D)).astype(np.float32)
    task_mask = np.ones((batch, 2), bool)
    obs_mask = np.ones((batch, horizon, 4), bool)
    if pad:  # a padded task token and a padded first frame
        task_mask[1, 1] = False
        obs_mask[0, 0] = False
    rules = pkg.AttentionRule
    prefix = pkg.PrefixGroup(
        tokens=asarray(task), mask=asarray(task_mask), name="task_language",
        attention_rules={"task_*": rules.CAUSAL})
    obs_group = pkg.TimestepGroup(
        tokens=asarray(obs), mask=asarray(obs_mask), name="obs_primary",
        attention_rules={"task_*": rules.CAUSAL, "obs_*": rules.CAUSAL})
    readout = pkg.TimestepGroup(
        tokens=asarray(np.zeros((batch, horizon, 1, D), np.float32)),
        mask=asarray(np.ones((batch, horizon, 1), bool)),
        name="readout_action",
        attention_rules={"task_*": rules.CAUSAL, "obs_*": rules.CAUSAL,
                         "readout_action": rules.CAUSAL})
    return [prefix], [obs_group, readout]


@pytest.mark.parametrize("correct", [False, True])
@pytest.mark.parametrize("pad", [False, True])
def test_block_transformer_masks_match_jax(correct, pad):
    ref = jbt.BlockTransformer(KWARGS, use_correct_attention=correct)
    got = bt.BlockTransformer(KWARGS, use_correct_attention=correct)
    jmask = ref.generate_attention_mask(*_groups(jbt, pad=pad))
    mask = got.generate_attention_mask(*_groups(bt, pad=pad))
    assert mask.dtype == torch.bool
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(
        got.generate_pad_attention_mask(*_groups(bt, pad=pad)).numpy(),
        np.asarray(ref.generate_pad_attention_mask(*_groups(jbt, pad=pad))))


@pytest.mark.parametrize("rule", ["CURRENT", "STRICT_PAST", "NEVER"])
def test_each_rule_fills_the_jax_blocks(rule):
    masks = []
    for pkg in (jbt, bt):
        prefix, (obs, readout) = _groups(pkg)
        readout.attention_rules["obs_*"] = getattr(pkg.AttentionRule, rule)
        masks.append(np.asarray(pkg.BlockTransformer(KWARGS)
                                .generate_attention_mask(prefix,
                                                         [obs, readout])))
    np.testing.assert_array_equal(masks[1], masks[0])


def test_causality_is_enforced_as_in_jax():
    for pkg in (jbt, bt):
        prefix, timestep = _groups(pkg)
        prefix[0] = prefix[0].replace(
            attention_rules={"obs_primary": pkg.AttentionRule.CAUSAL})
        with pytest.raises(AssertionError, match="Causality broken"):
            pkg.BlockTransformer(KWARGS).generate_attention_mask(prefix,
                                                                 timestep)
        prefix, timestep = _groups(pkg)
        timestep[0] = timestep[0].replace(attention_rules={
            **timestep[0].attention_rules, "task_*": pkg.AttentionRule.ALL})
        with pytest.raises(AssertionError, match="ALL"):
            pkg.BlockTransformer(KWARGS).generate_attention_mask(prefix,
                                                                 timestep)
    assert bt.find_match({"obs_*": 1, "*": 2}, "obs_wrist", 0) == 1
    assert bt.find_match({"task_*": 1}, "readout_action", 0) == 0


@pytest.mark.parametrize("learnable_norm", [True, False])
def test_block_transformer_forward_matches_jax(learnable_norm):
    kwargs = dict(KWARGS, learnable_norm=learnable_norm)
    ref = jbt.BlockTransformer(kwargs, use_correct_attention=True)
    jgroups = _groups(jbt, pad=True)
    variables = _perturbed(ref.init(jax.random.PRNGKey(0), *jgroups,
                                    train=False))
    jprefix, jtimestep = ref.apply(variables, *jgroups, train=False)
    got = bt.BlockTransformer(kwargs, use_correct_attention=True)
    params = _ported(variables["params"], "bt")
    _assert_specs(got.specs("bt", D), params)
    prefix, timestep = got(params, "bt", *_groups(bt, pad=True))
    for g, j in zip(prefix + timestep, jprefix + jtimestep):
        assert g.name == j.name
        np.testing.assert_allclose(g.tokens.numpy(), np.asarray(j.tokens),
                                   **TOL)


# ------------------------------ MAP and FiLM ------------------------------


@pytest.mark.parametrize("readouts", [1, 3])
def test_map_head_matches_jax(readouts):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 5, D)).astype(np.float32)
    mask = rng.random((2, 3, 5)) > 0.3
    mask[..., 0] = True
    ref = JaxMAPHead(num_readouts=readouts)
    group = jtok.TokenGroup(jnp.asarray(x), jnp.asarray(mask))
    variables = _perturbed(ref.init(jax.random.PRNGKey(0), group,
                                    train=False))
    want = ref.apply(variables, group, train=False)
    params = _ported(variables["params"], "m")
    _assert_specs(map_head_specs("m", D, readouts), params)
    got = map_head(params, "m", torch.tensor(x), torch.tensor(mask),
                   num_readouts=readouts)
    assert got.shape == (2, 3, readouts, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_film_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 4, 4, 8)).astype(np.float32)
    z = rng.standard_normal((3, 5)).astype(np.float32)
    variables = _perturbed(JaxFilm().init(jax.random.PRNGKey(0), x, z))
    want = JaxFilm().apply(variables, x, z)
    params = _ported(variables["params"], "f")
    _assert_specs(film_specs("f", 5, 8), params)
    got = film_conditioning(params, "f",
                            torch.tensor(x).permute(0, 3, 1, 2),
                            torch.tensor(z)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


STEM_CASES = {
    "patchify-16-film": dict(num_features=16),
    "small-stem-16-film": dict(num_features=16, features=(32, 32),
                               kernel_sizes=(3, 3), strides=(2, 2),
                               padding=(1, 1)),
    "small-stem-8-film": dict(num_features=16, features=(32, 32, 32)),
    "small-stem-16": dict(num_features=16, features=(32, 32),
                          kernel_sizes=(3, 3), strides=(2, 2),
                          padding=(1, 1)),
}


@pytest.mark.parametrize("name", sorted(STEM_CASES))
def test_named_stems_match_jax(name):
    kw = STEM_CASES[name]
    ref = jvit.vit_encoder_configs[name](**kw)
    got = vit.vit_encoder_configs[name](**kw)
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (2, 32, 32, 6), dtype=np.uint8)
    cond = rng.standard_normal((2, 5)).astype(np.float32)
    film = {"cond_var": cond} if got.use_film else {}
    variables = _perturbed(ref.init(jax.random.PRNGKey(0), images, **film))
    want = ref.apply(variables, images, **film)
    params = _ported(variables["params"], "s")
    _assert_specs(got.specs("s", 6, 5 if got.use_film else None), params)
    got_film = {"cond_var": torch.tensor(cond)} if got.use_film else {}
    out = got(params, "s", torch.tensor(images), **got_film)
    np.testing.assert_allclose(out.numpy(), np.asarray(want).reshape(
        out.shape), **TOL)
    assert sorted(vit.vit_encoder_configs) == sorted(jvit.vit_encoder_configs)


def test_small_stem_16_and_the_film_contract():
    assert vit.SmallStem16().patch_size == 16
    stem = vit.SmallStem16(use_film=True)
    with pytest.raises(AssertionError, match="cond_var iff use_film"):
        stem({}, "s", torch.zeros((1, 32, 32, 3), dtype=torch.uint8))
    # the "imagenet" normalization (tests/test_torch_resnet_stems.py holds
    # it to the JAX one) reaches the stem's convolution
    img = np.random.default_rng(0).integers(0, 256, (1, 32, 32, 3),
                                            dtype=np.uint8)
    ref = jvit.PatchEncoder(img_norm_type="imagenet", patch_size=16)
    variables = _perturbed(ref.init(jax.random.PRNGKey(0), img))
    got = vit.PatchEncoder(img_norm_type="imagenet", patch_size=16)(
        _ported(variables["params"], "s"), "s", torch.tensor(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.apply(
        variables, img)).reshape(got.shape), **TOL)


# ------------------------------ tokenizers ------------------------------


def _obs_task(seed=4, window=2, goal=True, pad=True):
    rng = np.random.default_rng(seed)
    obs = {"image_primary": rng.integers(0, 256, (2, window, 32, 32, 3),
                                         dtype=np.uint8),
           "timestep_pad_mask": np.ones((2, window), bool)}
    if pad:
        obs["pad_mask_dict"] = {"image_primary": np.array(
            [[False, True], [True, True]])[:, :window]}
    task = {"language_instruction": rng.standard_normal(
        (2, 6)).astype(np.float32),
        "pad_mask_dict": {"language_instruction": np.array([True, False])}}
    if goal:
        task["image_primary"] = rng.integers(0, 256, (2, 32, 32, 3),
                                             dtype=np.uint8)
    return obs, task


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.tensor(v)
            for k, v in tree.items()}


IMAGE_CASES = {
    "goal": dict(task_stack_keys=["image_primary"]),
    "film": dict(task_film_keys=["language_instruction"], film=True),
    "token_learner": dict(use_token_learner=True, num_tokens=3),
    "no_pad_mask": dict(proper_pad_mask=False),
}


@pytest.mark.parametrize("case", sorted(IMAGE_CASES))
def test_image_tokenizer_matches_jax(case):
    kw = dict(IMAGE_CASES[case])
    film = kw.pop("film", False)
    encoder = dict(num_features=D, features=(32, 32), kernel_sizes=(3, 3),
                   strides=(2, 2), padding=(1, 1), use_film=film)
    jspec = JaxSpec.create("hypervla_tpu.models.vit_encoders:SmallStem16",
                           **encoder)
    ref = jtok.ImageTokenizer(encoder=jspec, obs_stack_keys=["image_.*"],
                              **kw)
    got = tok.ImageTokenizer(encoder=port_module_specs(jspec),
                             obs_stack_keys=["image_.*"], **kw)
    obs, task = _obs_task()
    variables = _perturbed(ref.init(jax.random.PRNGKey(0), obs, task,
                                    train=False))
    want = ref.apply(variables, obs, task, train=False)
    params = _ported(variables["params"], "t")
    _assert_specs(got.specs("t", obs, task), params)
    out = got(params, "t", _torch_tree(obs), _torch_tree(task))
    np.testing.assert_allclose(out.tokens.numpy(), np.asarray(want.tokens),
                               **TOL)
    np.testing.assert_array_equal(out.mask.numpy(),
                                  np.asarray(want.mask).astype(bool))


def test_image_tokenizer_zero_pads_a_missing_goal_and_skips_no_images():
    spec = ModuleSpec.create("hypervla_tpu_torch.models.vit_encoders:"
                             "PatchEncoder", patch_size=16, num_features=D)
    got = tok.ImageTokenizer(encoder=spec, task_stack_keys=["image_.*"])
    obs, task = _obs_task(goal=False)
    params = {k: torch.ones(s) for k, (s, _) in got.specs(
        "t", obs, task).items()}
    assert params["t/PatchEncoder_0/embedding/kernel"].shape[2] == 6
    zero_goal = dict(task, image_primary=np.zeros((2, 32, 32, 3), np.uint8))
    np.testing.assert_array_equal(
        got(params, "t", _torch_tree(obs), _torch_tree(task)).tokens,
        got(params, "t", _torch_tree(obs), _torch_tree(zero_goal)).tokens)
    assert got(params, "t", {"proprio": torch.zeros(2, 2, 3)}, {}) is None


@pytest.mark.parametrize("pad", [True, False])
def test_language_tokenizer_matches_jax(pad):
    _, task = _obs_task()
    if not pad:
        del task["pad_mask_dict"]
    ref = jtok.LanguageTokenizer()
    want = ref.apply({}, {}, task)
    out = tok.LanguageTokenizer()({}, "l", {}, _torch_tree(task))
    np.testing.assert_array_equal(out.tokens.numpy(),
                                  np.asarray(want.tokens))
    np.testing.assert_array_equal(out.mask.numpy(),
                                  np.asarray(want.mask).astype(bool))
    assert tok.LanguageTokenizer()({}, "l", {}, {}) is None
    # token ids without an encoder (the in-model T5 is held to the JAX one
    # in tests/test_torch_resnet_stems.py)
    ids = {"language_instruction": {"input_ids": np.zeros((1, 2), np.int32),
                                    "attention_mask": np.ones((1, 2))}}
    with pytest.raises(AssertionError, match="no encoder specified"):
        jtok.LanguageTokenizer().apply({}, {}, ids)
    with pytest.raises(AssertionError, match="no encoder specified"):
        tok.LanguageTokenizer()({}, "l", {}, ids)


@pytest.mark.parametrize("discretize", [False, True])
def test_lowdim_tokenizer_matches_jax(discretize):
    rng = np.random.default_rng(5)
    obs = {"proprio": rng.uniform(-1.2, 1.2, (2, 3, 4)).astype(np.float32),
           "proprio_extra": rng.uniform(-1, 1, (2, 3, 2)).astype(np.float32)}
    kw = dict(obs_keys=["proprio.*"], discretize=discretize, n_bins=8)
    want = jtok.LowdimObsTokenizer(**kw).apply({}, obs)
    out = tok.LowdimObsTokenizer(**kw)({}, "o", _torch_tree(obs))
    np.testing.assert_array_equal(out.tokens.numpy(),
                                  np.asarray(want.tokens))
    assert out.mask.all()
    assert tok.LowdimObsTokenizer(obs_keys=["state"])({}, "o",
                                                      _torch_tree(obs)) is None


def test_proper_pad_mask_and_regex_helpers_match_jax():
    tokens = torch.zeros((2, 3, 4, 5))
    masks = {"a": np.array([[1, 0, 1], [0, 0, 1]], bool),
             "b": np.array([[0, 0, 1], [1, 0, 0]], bool)}
    want = jtok.generate_proper_pad_mask(jnp.zeros((2, 3, 4, 5)), masks,
                                         ("a", "b"))
    got = tok.generate_proper_pad_mask(tokens, _torch_tree(masks),
                                       ("a", "b"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tok.generate_proper_pad_mask(tokens, None, ("a",)).all()
    assert tok.generate_proper_pad_mask(tokens, {}, ("a",)).all()
    keys = ["image_primary", "image_wrist", "depth_primary", "proprio"]
    for patterns in (["image_.*"], ["image_.*", "depth_.*"], ["wrist"]):
        assert tok.regex_filter(patterns, keys) == jtok.regex_filter(
            patterns, keys)
    out = TokenGroup.concatenate([TokenGroup.create(torch.ones(2, 3, 4)),
                                  TokenGroup(torch.zeros(2, 1, 4), None)])
    assert out.tokens.shape == (2, 4, 4) and out.mask.all()
