"""The trunk's attention capture and InferenceWrapper(save_attention_map=
True) against the JAX package on the tiny DINOv2 twin on the CPU:

  * the trunk's per-layer attention probabilities (sow_dino_attention,
    models/encoders/dinov2.py's `attentions`) against the JAX trunk's
    sown DINO_attention_map, to 1e-5;
  * the wrapper leaves the fused step, as the JAX one does, and keeps
    dino_attention_map (trunk layers, heads, 256: each layer's class-token
    row without itself) and head_attention_map (policy layers, heads,
    tokens - 1: each layer's last row without itself), held to the JAX
    wrapper's on the same params and frames (the JAX wrapper's resized
    pixels fed to both, tests/test_torch_host_path.py::step_both).
"""
import jax
import numpy as np
import torch

from hypervla_tpu.configs.defaults import tiny_test_config as jax_tiny_config
from hypervla_tpu.eval.inference import InferenceWrapper as JaxWrapper
from hypervla_tpu.models.base_vit import ViT as JaxViT
from hypervla_tpu.utils.static import static_dict
from hypervla_tpu_torch.eval.inference import InferenceWrapper
from hypervla_tpu_torch.models.base_vit import ViT
from hypervla_tpu_torch.utils.convert import from_jax_params
from test_torch_harness import torch_threads  # noqa: F401
from test_torch_host_path import step_both
from test_torch_serving import STATS, _build


def test_trunk_attention_maps_match_jax():
    kw = dict(jax_tiny_config("DINOv2")["base_net_kwargs"]["vit_kwargs"],
              pretrained_encoder_name="dinov2-test", sow_dino_attention=True)
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (2, 224, 224, 3)).astype(np.uint8)
    instruction = rng.randn(2, 5, 12).astype(np.float32)
    jvit = JaxViT(**kw, action_token_num=1)
    variables = jvit.init(jax.random.PRNGKey(0), images, instruction,
                          train=False)
    _, state = jvit.apply(variables, images, instruction, train=False,
                          mutable=["intermediates"])
    ref = state["intermediates"]["DINO_attention_map"][0]
    params = {f"encoder/{k}": v for k, v in from_jax_params(
        jax.tree_util.tree_map(np.asarray, variables["params"])).items()}
    vit = ViT(kw, 1)
    maps = []
    with torch.no_grad():
        vit.image_embeddings(params, torch.tensor(images), "layers", maps)
    assert len(maps) == len(ref) == 2
    for got, want in zip(maps, ref):
        assert got.shape == (2, 2, 257, 257)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


def test_save_attention_map_matches_the_jax_wrapper():
    jmodel, _, model, _, frames, _ = _build({}, 32)
    jmodel = jmodel.replace(dataset_statistics=static_dict({"action": STATS}))
    model = model.replace(dataset_statistics={"action": STATS})
    example = model.example_batch
    instruction = {"language_instruction":
                   example["task"]["language_instruction"]}
    kwargs = dict(policy_setup="libero", pred_action_horizon=2,
                  image_size=224, save_attention_map=True)
    jwrapper = JaxWrapper(model=jmodel, fused_serving=True, **kwargs)
    wrapper = InferenceWrapper(model, fused_serving=True, **kwargs)
    assert not jwrapper.fused_serving and not wrapper.fused_serving
    for w in (jwrapper, wrapper):
        w.reset("pick up the cube", instruction, example["initial_state"])
    for frame in frames[:2]:
        (raw_j, _), (raw, _) = step_both(jwrapper, wrapper, frame)
        np.testing.assert_allclose(raw, raw_j, atol=1e-5)
        assert wrapper.dino_attention_map.shape == (2, 2, 256)
        assert wrapper.head_attention_map.shape == (2, 2, 256)
        for name in ("dino_attention_map", "head_attention_map"):
            np.testing.assert_allclose(
                getattr(wrapper, name),
                np.asarray(getattr(jwrapper, name), np.float32),
                rtol=1e-5, atol=1e-6, err_msg=name)
