"""tools/convert_checkpoint_to_torch.py on the checkpoints of this slice's
models: the JAX package writes a tiny BaseModel checkpoint (its params the
base net's tree) and a tiny differential-attention HyperVLA checkpoint
inside the test; the tool converts each; the port's loader reads it back
and gives the JAX actions to 1e-5 on the same inputs. The HyperVLA
checkpoint is no BaseModel's for the tool (`is_base_model`), whatever its
config's model_class says."""
import jax
import numpy as np
import torch

from hypervla_tpu.configs import tiny_test_config as jax_tiny_config
from hypervla_tpu.flagship import make_flagship_batch as jax_batch
from hypervla_tpu.models.base_model import BaseModel as JaxBaseModel
from hypervla_tpu.models.hypervla import HyperVLA as JaxHyperVLA
from hypervla_tpu_torch.models.base_model import BaseModel
from hypervla_tpu_torch.models.hypervla import HyperVLA
from test_torch_base_model import ablation
from test_torch_harness import torch_threads  # noqa: F401
from test_torch_jax_draws import PAIR_BATCH
from tools.convert_checkpoint_to_torch import convert, is_base_model

TOL = dict(rtol=1e-5, atol=1e-5)
STATS = {"action": {"mean": np.zeros(7, np.float32),
                    "std": np.ones(7, np.float32),
                    "mask": np.ones(7, bool)}}


def _perturbed(params, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + rng.standard_normal(np.shape(v)) * scale
                   ).astype(np.float32), params)


def _instr(batch):
    return {"language_instruction": {
        k: v[:1] for k, v in batch["task"]["language_instruction"].items()}}


def test_base_model_checkpoint_converts(tmp_path):
    config = jax_tiny_config("DINOv2")
    ablation(config)
    batch = jax_batch(batch_size=1, **PAIR_BATCH)
    jmodel = JaxBaseModel.from_config(config, batch,
                                      dataset_statistics=STATS)
    jmodel = jmodel.replace(params=_perturbed(jmodel.params))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jmodel.save_pretrained(7, checkpoint_path=jdir)
    assert is_base_model(jdir, config, 7)
    assert convert(jdir, tdir) == [7]
    instr = _instr(batch)
    want, _ = jmodel.sample_actions(
        batch["observation"]["image_primary"], instr, None,
        batch["observation"]["timestep_pad_mask"], jmodel.params,
        rng=jax.random.PRNGKey(0))
    model = BaseModel.load_pretrained(tdir, device="cpu")
    params, _ = model.create_tasks(instruction_dict=instr)
    got = model.sample_actions(batch["observation"]["image_primary"], instr,
                               None, None, params, rng=torch.Generator(),
                               trunk_impl="layers")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_differential_hypervla_checkpoint_converts(tmp_path):
    config = jax_tiny_config("DINOv2")
    config["base_net_kwargs"]["vit_kwargs"][
        "use_differential_transformer"] = True
    # a HyperVLA's params under the ablation's model_class, as the JAX
    # trainer saves a base_pretrain_config run
    config["model_class"] = "base_model"
    batch = jax_batch(batch_size=1, **PAIR_BATCH)
    jmodel = JaxHyperVLA.from_config(config, batch, jax.random.PRNGKey(0),
                                     dataset_statistics=STATS)
    jmodel = jmodel.replace(params=_perturbed(jmodel.params, scale=0.02))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jmodel.save_pretrained(step=3, checkpoint_path=jdir)
    assert not is_base_model(jdir, config, 3)
    assert convert(jdir, tdir) == [3]
    instr = _instr(batch)
    initial = {"patch_embeddings": batch["initial_state"][
        "patch_embeddings"][:1]}
    jparams, jtask, _ = jmodel.create_tasks(instruction_dict=instr,
                                            initial_state=initial)
    want, _ = jmodel.sample_actions(
        batch["observation"]["image_primary"], instr, jtask,
        batch["observation"]["timestep_pad_mask"], jparams,
        rng=jax.random.PRNGKey(0))
    model = HyperVLA.load_pretrained(tdir, device="cpu")
    params, task = model.create_tasks(instruction_dict=instr,
                                      initial_state=initial)
    got = model.sample_actions(batch["observation"]["image_primary"], instr,
                               task, None, params, trunk_impl="layers")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
