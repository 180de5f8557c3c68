"""The pretrained-trunk encoders of the policy ViT beside DINOv2: CLIP
(hypervla_tpu_torch/models/encoders/clip.py, the ViT's "CLIP" branch) and
SigLIP (precomputed patch embeddings from the batch), against the JAX
package on the same numpy inputs and the JAX params carried across, in
fp32 to 1e-5:

  * CLIPVisionModel on the JAX module's clip-test geometry: the last
    hidden state (the raw encoder output: post_layernorm stays in the tree
    and touches nothing) and the attention maps;
  * the tiny DINOv2 twin with encoder_type CLIP, its hard-coded
    clip-vit-base-patch16 swapped for clip-test in both packages for the
    file (a runtime patch of each package's named-config table): the weight
    plan, create_tasks, sample_actions and one train step (loss,
    grad_norm, every gradient), the trunk batched in the port as the JAX
    step's hoisted trunk;
  * a CLIP plan whose image encoder is not shared: AssertionError in both;
  * the same for Siglip, whose embeddings ride in the batch (an example
    batch without them: IndexError in both);
  * the full-width CLIP-base flagship's plan against the JAX plan, derived
    with jax.jit stood in by jax.eval_shape (nothing compiled).
"""
import jax
import numpy as np
import pytest
import torch

from helpers import make_example_batch
from hypervla_tpu.configs import flagship_pretrain_config as jax_flagship
from hypervla_tpu.configs import tiny_test_config as jax_tiny_config
from hypervla_tpu.models.encoders import clip as jclip
from hypervla_tpu.models.hypervla import HyperVLA as JaxHyperVLA
from hypervla_tpu_torch.configs import (
    flagship_pretrain_config,
    tiny_test_config,
)
from hypervla_tpu_torch.flagship import make_flagship_batch
from hypervla_tpu_torch.models.base_network import BaseNetwork
from hypervla_tpu_torch.models.draws import Draws
from hypervla_tpu_torch.models.encoders import clip
from hypervla_tpu_torch.models.hypervla import HyperVLA
from hypervla_tpu_torch.models.weight_plan import (
    build_weight_plan,
    input_shapes,
)
from hypervla_tpu_torch.utils.convert import from_jax_params
from test_torch_differential import _offsets
from test_torch_harness import torch_threads  # noqa: F401
from test_torch_jax_draws import (
    assert_grads_close,
    build_pair,
    dropout_keys,
    jax_reference,
    port_step_grads,
)
from test_torch_octo_layers import _perturbed

TOL = dict(rtol=1e-5, atol=1e-5)
BATCH = 4
SIGLIP_TOKENS, SIGLIP_DIM = 16, 24


def _leaves(tree):
    return {"/".join(k.key for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def tiny_clip():
    """Both packages' clip-vit-base-patch16 as clip-test while the file
    runs."""
    with pytest.MonkeyPatch.context() as mp:
        for table in (jclip._NAMED_CONFIGS, clip._NAMED_CONFIGS):
            mp.setitem(table, "clip-vit-base-patch16", table["clip-test"])
        yield


@pytest.mark.parametrize("attentions", [False, True])
def test_clip_vision_model_matches_jax(attentions):
    rng = np.random.default_rng(0)
    pixels = rng.standard_normal((2, 48, 48, 3)).astype(np.float32)
    config = jclip.clip_vision_config("clip-test")
    ref = jclip.CLIPVisionModel(config=config)
    variables = _perturbed(ref.init(jax.random.PRNGKey(0), pixels))
    want = ref.apply(variables, pixels, output_attentions=attentions)
    params = from_jax_params(variables["params"])
    model = clip.CLIPVisionModel(clip.clip_vision_config("clip-test"))
    specs = model.specs(image_size=48)
    assert {k: tuple(s) for k, (s, _) in specs.items()} == {
        k: tuple(v.shape) for k, v in params.items()}
    got = model(params, torch.tensor(pixels), output_attentions=attentions)
    np.testing.assert_allclose(got.last_hidden_state.numpy(),
                               np.asarray(want.last_hidden_state), **TOL)
    if attentions:
        assert len(got.attentions) == config.num_hidden_layers
        for g, w in zip(got.attentions, want.attentions):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    else:
        assert got.attentions is None
    # post_layernorm is in the tree and leaves the hidden state alone
    params["vision_model/post_layernorm/scale"] = params[
        "vision_model/post_layernorm/scale"] * 3.0
    np.testing.assert_array_equal(
        model(params, torch.tensor(pixels)).last_hidden_state.numpy(),
        got.last_hidden_state.numpy())


def test_quick_gelu_and_the_named_configs():
    x = np.linspace(-4, 4, 33).astype(np.float32)
    np.testing.assert_allclose(clip.quick_gelu(torch.tensor(x)).numpy(),
                               np.asarray(jclip.quick_gelu(x)), **TOL)
    for name, config in jclip._NAMED_CONFIGS.items():
        assert vars(clip.clip_vision_config(name)) == vars(config)
    with pytest.raises(ValueError):
        clip.clip_vision_config("clip-nope")


# ------------------------------ the twins ------------------------------


def _clip(config):
    config["base_net_kwargs"]["vit_kwargs"]["encoder_type"] = "CLIP"


def _siglip(config):
    config["base_net_kwargs"]["vit_kwargs"]["encoder_type"] = "Siglip"


def _siglip_batch(batch):
    rng = np.random.default_rng(7)
    batch["observation"]["patch_embeddings"] = rng.standard_normal(
        (batch["action"].shape[0], SIGLIP_TOKENS, SIGLIP_DIM)).astype(
            np.float32)


@pytest.fixture(scope="module")
def pairs(tiny_clip):
    return {"CLIP": build_pair(_clip, batch_size=BATCH),
            "Siglip": build_pair(_siglip, batch_size=BATCH,
                                 batch_change=_siglip_batch)}


@pytest.mark.parametrize("encoder", ["CLIP", "Siglip"])
def test_plan_matches_the_jax_weight_plan(pairs, encoder):
    jmodel, _, model, _, _, _ = pairs[encoder]
    md = jmodel.base_net_metadata
    shapes = {k: tuple(v) for k, v in _leaves(md["param_shape"]).items()}
    assert list(shapes) == model.plan.names
    assert shapes == model.plan.param_shape
    assert _offsets(list(shapes), shapes) == _offsets(
        model.plan.names, model.plan.param_shape)
    assert _leaves(md["token_index_dict"]) == model.plan.token_index
    assert _leaves(md["generation_flag"]) == model.plan.generation_flag
    assert md["output_head_info"] == model.plan.output_head_info
    assert md["pretrained_block_path"] == model.plan.pretrained_block_path


@pytest.mark.parametrize("encoder", ["CLIP", "Siglip"])
def test_create_tasks_and_sample_actions_match_jax(pairs, encoder):
    jmodel, _, model, _, jbatch, batch = pairs[encoder]
    instr = {"language_instruction": {
        k: v[:1] for k, v in jbatch["task"]["language_instruction"].items()}}
    initial = {"patch_embeddings": jbatch["initial_state"][
        "patch_embeddings"][:1]}
    emb = jbatch["observation"].get("patch_embeddings")
    emb = None if emb is None else emb[:1]
    jparams, jtask, _ = jmodel.create_tasks(instruction_dict=instr,
                                            initial_state=initial)
    want, _ = jmodel.sample_actions(
        jbatch["observation"]["image_primary"][:1], instr, jtask,
        jbatch["observation"]["timestep_pad_mask"][:1], jparams,
        rng=jax.random.PRNGKey(0), image_embeddings=emb)
    params, task = model.create_tasks(instruction_dict=instr,
                                      initial_state=initial)
    got = model.sample_actions(batch["observation"]["image_primary"][:1],
                               instr, task, None, params,
                               image_embeddings=emb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("encoder", ["CLIP", "Siglip"])
def test_train_step_matches_jax(pairs, encoder):
    jmodel, jconfig, model, config, jbatch, batch = pairs[encoder]
    ref = jax_reference(jmodel, jconfig, jbatch,
                        dropout_keys(jax.random.PRNGKey(0), BATCH))
    info, grads = port_step_grads(model, config, batch,
                                  Draws(replay=ref["sites"]))
    np.testing.assert_allclose(info["training_loss"], ref["loss"], rtol=1e-5)
    grad_norm = float(np.sqrt(sum((np.asarray(g, np.float64) ** 2).sum()
                                  for g in ref["grads"].values())))
    np.testing.assert_allclose(info["grad_norm"], grad_norm, rtol=1e-5)
    assert_grads_close(grads, ref["grads"])


def test_unshared_clip_and_siglip_without_embeddings_raise_as_in_jax(
        tiny_clip):
    """A CLIP trunk outside shared_modules (one context token a module):
    the JAX plan's AssertionError; a Siglip model whose example batch has
    no patch embeddings: the JAX init's IndexError."""
    hk = dict(share_layer_index=False, shared_modules=())
    batch = make_example_batch(image_size=224, initial_image=True,
                               initial_patch_dim=32)
    jconfig = jax_tiny_config("DINOv2", hypernet_kwargs=dict(hk))
    config = tiny_test_config(hypernet_kwargs=dict(hk))
    _clip(jconfig)
    _clip(config)
    with pytest.raises(AssertionError, match="must be shared"):
        JaxHyperVLA.from_config(jconfig, batch, jax.random.PRNGKey(0))
    with pytest.raises(AssertionError, match="must be shared"):
        HyperVLA.from_config(config, batch, device="cpu")
    jconfig, config = jax_tiny_config("DINOv2"), tiny_test_config()
    _siglip(jconfig)
    _siglip(config)
    with pytest.raises(IndexError):
        JaxHyperVLA.from_config(jconfig, batch, jax.random.PRNGKey(0))
    with pytest.raises(IndexError):
        HyperVLA.from_config(config, batch, device="cpu")


def test_full_width_clip_plan_matches_jax(monkeypatch):
    """The vit_t,oxe recipe with encoder_type CLIP at full width (CLIP-base,
    12 x 768, 224 px): names, shapes, flat size, token indices and head
    info against the JAX plan."""
    from hypervla_tpu.models.weight_plan import init_base_net as jax_plan

    monkeypatch.setattr(jax, "jit", lambda fn, **_: (
        lambda *args: jax.eval_shape(fn, *args)))
    jconfig, config = jax_flagship(), flagship_pretrain_config()
    for c in (jconfig, config):
        _clip(c)
    batch = make_flagship_batch()
    _, _, _, md = jax_plan(jconfig, batch, jax.random.PRNGKey(0))
    base_net = BaseNetwork(**config["base_net_kwargs"],
                           input_shapes=input_shapes(batch))
    plan = build_weight_plan(config, base_net)
    shapes = {k: tuple(v) for k, v in _leaves(md["param_shape"]).items()}
    assert list(shapes) == plan.names
    assert shapes == plan.param_shape
    assert md["total_param_num"] == plan.total_param_num
    assert _leaves(md["token_index_dict"]) == plan.token_index
    assert md["output_head_info"] == plan.output_head_info
    assert "encoder/image_encoder/vision_model/pre_layrnorm/scale" in shapes
