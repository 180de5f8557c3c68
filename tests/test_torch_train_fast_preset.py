"""One step of the port's train step under the fast preset against the
JAX package's, from the same params and batch, on the tiny flagship twin
with dinov2-test-wide on the CPU (JAX's Pallas kernels in interpret mode):
the bf16 trunk with the fused training attention, fine-tuned, so the
attention backward runs; the in-step frozen T5 and frozen DINOv2 encodes,
the DINOv2 layers through the no-residual layer forward. Loss within 2e-2
rel and the post-update params per leaf at cosine > 0.98: the bounds the
JAX package holds between its own trunks
(tests/test_layer_kernel_train_step.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from hypervla_tpu.configs import apply_fast_training_preset as jax_preset
from hypervla_tpu.configs import tiny_test_config as jax_tiny_config
from hypervla_tpu.flagship import make_flagship_batch as jax_batch
from hypervla_tpu.models.encoders.dinov2 import DINOv2Model, dinov2_config
from hypervla_tpu.models.encoders.t5 import T5Config, T5EncoderModel
from hypervla_tpu.models.hypernetwork import rebuild_shared_subtree
from hypervla_tpu.models.hypervla import HyperVLA as JaxHyperVLA
from hypervla_tpu_torch.configs import (
    apply_fast_training_preset,
    tiny_test_config,
)
from hypervla_tpu_torch.flagship import make_flagship_batch
from hypervla_tpu_torch.models.base_vit import normalize_pixels
from hypervla_tpu_torch.models.encoders import t5 as tt5
from hypervla_tpu_torch.models.encoders.dinov2 import (
    dinov2_forward,
    pack_frozen_layers,
)
from hypervla_tpu_torch.models.hypervla import HyperVLA
from hypervla_tpu_torch.train.trainer import frozen_layer_kernel
from hypervla_tpu_torch.utils.convert import from_jax_params
from test_torch_train_step import BATCH, _cosine, _jax_step, _torch_step
from test_torch_harness import torch_threads  # noqa: F401

T5_SMALL = dict(vocab_size=1000, d_model=768, d_kv=16, d_ff=64,
                num_layers=1, num_heads=2)


_WIDE = dict(pretrained_encoder_name="dinov2-test-wide",
             fine_tune_pretrained_image_encoder=True)


def _jax_encoders(model):
    """The JAX step's frozen encoders: a small T5 and the conditioning
    DINOv2 through the Pallas layer forward, its params a copy of the
    trunk's initial ones (an init of its own would only cost time)."""
    t5 = T5EncoderModel(config=T5Config(**T5_SMALL))
    ids = jnp.ones((1, BATCH["instr_len"]), jnp.int32)
    t5_params = t5.init(jax.random.PRNGKey(1), ids)["params"]
    dino = DINOv2Model(config=dinov2_config("dinov2-test-wide"),
                       dtype=jnp.bfloat16, layers_impl="pallas_train")
    dino_params = jax.tree_util.tree_map(
        np.array, rebuild_shared_subtree(
            model.params, model.hypernet.base_net_metadata))
    mean = jnp.array((0.485, 0.456, 0.406))
    std = jnp.array((0.229, 0.224, 0.225))

    def dino_apply(params, images):
        raw = (images.astype(jnp.float32) / 255.0 - mean) / std
        return dino.apply({"params": params}, raw).last_hidden_state

    def text_apply(params, ids, mask):
        return t5.apply({"params": params}, ids, mask)

    return text_apply, dino_apply, {"t5": t5_params, "dino": dino_params}


def test_fast_preset_step_matches_jax():
    config = jax_tiny_config(encoder_type="DINOv2")
    config["base_net_kwargs"]["vit_kwargs"].update(_WIDE)
    config = jax_preset(config)
    config["EMA_start_step"] = 0
    example = jax_batch(instr_len=8, action_horizon=2, initial_patch_dim=128)
    jmodel = JaxHyperVLA.from_config(config, example, jax.random.PRNGKey(0))
    batch = jax_batch(**BATCH, initial_patch_dim=128)
    del batch["task"]["language_instruction"]["token_embedding"]
    del batch["initial_state"]["patch_embeddings"]
    encoders = _jax_encoders(jmodel)
    ref_params, _, ref_info = _jax_step(jmodel, config, batch, encoders)

    config = tiny_test_config()
    config["base_net_kwargs"]["vit_kwargs"].update(_WIDE)
    config = apply_fast_training_preset(config)
    config["EMA_start_step"] = 0
    model = HyperVLA.from_config(config, make_flagship_batch(
        instr_len=8, action_horizon=2, initial_patch_dim=128),
        device="cpu")
    model.params = from_jax_params(jmodel.params)
    assert frozen_layer_kernel(config)
    assert model.base_net.encoder.fused_attention
    enc = {k: from_jax_params(v) for k, v in encoders[2].items()}
    t5_cfg = tt5.T5Config(**T5_SMALL)
    dino_cfg = model.base_net.encoder.dino
    enc["dino"] = pack_frozen_layers(dino_cfg, enc["dino"])

    def text_apply(params, ids, mask):
        return tt5.t5_encode(t5_cfg, params, ids, mask)

    def dino_apply(params, images):
        return dinov2_forward(dino_cfg, params, normalize_pixels(images),
                              torch.bfloat16, layer_kernel=True)

    got_params, _, info = _torch_step(model, config, batch,
                                      (text_apply, dino_apply, enc))
    loss, ref_loss = info["training_loss"], ref_info["training_loss"]
    assert np.isfinite(loss)
    assert abs(loss - ref_loss) < 0.02 * abs(ref_loss), (loss, ref_loss)
    for name, ref in ref_params.items():
        if np.linalg.norm(np.asarray(ref)) < 1e-6:
            # a degenerate leaf (a zero-initialised key bias: softmax
            # ignores a uniform key shift, so its exact gradient is 0 and
            # both steps move it by rounding noise, where a leaf that learns
            # moves by ~lr = 1.5e-4 per element): the port's must be as small
            assert np.linalg.norm(got_params[name]) < 1e-6, name
        else:
            assert _cosine(got_params[name], np.asarray(ref)) > 0.98, name


