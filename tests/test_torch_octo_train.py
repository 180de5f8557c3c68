"""The port's Octo training driver (hypervla_tpu_torch/train/octo_train.py)
against scripts/octo_train.py, and HyperVLA with the Octo base net,
against the JAX package's on the CPU, fp32.

  * `run` for 2 steps on the same batches (a fixed dataset handed to
    both), from the same init (the JAX model's, converted), the same
    frozen T5 (the JAX init of t5-small, converted) and the same draws
    (each step's diffusion steps and noise, from the JAX run's dropout
    key chain): each step's loss and the final params to 1e-5; the
    command line writing its checkpoint; a process group of one rank bit
    for bit the run without one;
  * HyperVLA with model_type "octo" (the tiny SmallStem config, a 16-wide
    one-layer Octo transformer over an ImageTokenizer of SmallStem16):
    under share_layer_index the same params and the same train-step loss
    and gradients as the JAX step's per-sample loss; KeyError without
    share_layer_index and TypeError at serving, in both packages.

Both runs tokenize the instructions with FallbackTokenizer (no
tokenizer files are in the repository), whose word ids come from Python's
`hash`, salted per process. The runs take them from crc32 instead
(`salt_free_word_ids`): under the salted `hash` the runs' inputs changed
with the test worker's PYTHONHASHSEED, and at some salts (13, one of the
24 salts 0-23) a final param missed its 1e-5 bound by up to 1.12x
(ROADMAP.md C.2).
"""
import copy
import json
import os
import subprocess
import sys
import zlib

import flax
import jax
import numpy as np
import pytest
import torch

from helpers import make_example_batch
from hypervla_tpu.configs import tiny_test_config as jax_tiny_config
from hypervla_tpu.data import text_processing as jtext
from hypervla_tpu.models import action_heads as jah
from hypervla_tpu.models.hypervla import HyperVLA as JaxHyperVLA
from hypervla_tpu.train import trainer as jtrainer
from hypervla_tpu.utils.spec import ModuleSpec as JaxSpec
from hypervla_tpu_torch.configs import tiny_test_config
from hypervla_tpu_torch.data import text_processing as ttext
from hypervla_tpu_torch.models import action_heads as ah
from hypervla_tpu_torch.models.draws import Draws
from hypervla_tpu_torch.models.hypervla import HyperVLA
from hypervla_tpu_torch.train import octo_train
from hypervla_tpu_torch.train import trainer as ttrainer
from hypervla_tpu_torch.train.train_step import to_tensors
from hypervla_tpu_torch.utils.convert import (
    flatten_tree,
    from_jax_params,
    port_module_specs,
)
from test_torch_harness import torch_threads  # noqa: F401
from test_torch_jax_draws import (
    assert_grads_close,
    dropout_keys,
    jax_reference,
    port_step_grads,
)


BATCH, HORIZON, DIM, STEPS = 8, 2, 7, 2


class FixedDataset:
    """The same batches for both drivers: an iterable with the pipeline's
    prefetch and dataset_statistics."""

    dataset_statistics = {"fixture": {"action": {
        "mean": np.zeros(DIM, np.float32), "std": np.ones(DIM, np.float32)}}}

    def __init__(self, n=STEPS + 1, seed=0):
        rng = np.random.default_rng(seed)
        self.batches = []
        for i in range(n):
            act_mask = np.ones((BATCH, 1, HORIZON, DIM), bool)
            act_mask[: 2 + i, :, 1] = False  # chunks past their trajectory
            words = [b"pick up the block", b"open the drawer"]
            self.batches.append({
                "observation": {
                    "image_primary": rng.integers(
                        0, 256, (BATCH, 1, 64, 64, 3), dtype=np.uint8),
                    "timestep_pad_mask": np.ones((BATCH, 1), bool)},
                "task": {"language_instruction": np.array(
                    [words[j % 2] for j in range(BATCH)], dtype=object)},
                "action": rng.uniform(-1, 1, (BATCH, 1, HORIZON, DIM))
                .astype(np.float32),
                "action_pad_mask": act_mask,
                "dataset_name": np.array([b"fixture"] * BATCH,
                                         dtype=object),
            })

    def prefetch(self, n):
        return self

    def __iter__(self):
        return iter(copy.deepcopy(self.batches))


def octo_train_config():
    """tests/test_octo_train.py's config, its T5 t5-small."""
    return {
        "seed": 0, "num_steps": STEPS, "log_interval": 1, "window_size": 1,
        "base_net_kwargs": {"action_horizon": HORIZON, "action_dim": DIM},
        "hypernet_kwargs": {},
        "optimizer": {
            "learning_rate": {"name": "constant", "init_value": 1e-4,
                              "peak_value": 3e-4, "warmup_steps": 1},
            "clip_gradient": 1.0, "weight_decay": 0.01},
        "dataset_kwargs": {"batch_size": BATCH, "text_tokenizer": "t5-small",
                           "tokenizer_max_length": 8},
        "model": {
            "observation_tokenizers": {"primary": JaxSpec.create(
                "hypervla_tpu.models.tokenizers:ImageTokenizer",
                obs_stack_keys=["image_primary"], task_stack_keys=[],
                encoder=JaxSpec.create(
                    "hypervla_tpu.models.vit_encoders:SmallStem16",
                    features=(32, 32), kernel_sizes=(3, 3), strides=(8, 2),
                    padding=(1, 1), num_features=16))},
            "heads": {"action": JaxSpec.create(
                "hypervla_tpu.models.action_heads:DiffusionActionHead",
                readout_key="readout_action", use_map=False,
                action_horizon=HORIZON, action_dim=DIM,
                n_diffusion_samples=1, time_dim=8, num_blocks=1,
                hidden_dim=16)},
            "readouts": {"action": 1},
            "transformer_kwargs": {
                "num_layers": 1, "mlp_dim": 32, "num_attention_heads": 2,
                "dropout_rate": 0.0, "attention_dropout_rate": 0.0,
                "add_position_embedding": False},
            "token_embedding_size": 16, "max_horizon": 4,
            "repeat_task_tokens": False, "use_correct_attention": True,
        },
        "text_processor": None,
        "save_interval": STEPS,
    }


def jax_step_draws(jmodel, seed, steps, batch):
    """{port site: draw} of each step of the JAX run: the diffusion head's
    first make_rng under the step's dropout key (the run's key chain),
    its steps and noise moved batch-leading."""
    head = jmodel.module.heads["action"]
    rng, out = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        rng, dropout_rng = jax.random.split(rng)
        bound = jmodel.module.bind({"params": jmodel.params},
                                   rngs={"dropout": dropout_rng})
        key = bound.heads["action"].make_rng("dropout")
        time_key, noise_key = jax.random.split(key)
        lead = (head.n_diffusion_samples, batch, 1)
        time = jax.random.randint(time_key, (*lead, 1), 0,
                                  head.diffusion_steps)
        noise = jax.random.normal(noise_key,
                                  (*lead, head.action_dim
                                   * head.action_horizon))
        out.append({"action_head/time": np.moveaxis(np.asarray(time), 0, 1),
                    "action_head/noise": np.moveaxis(np.asarray(noise), 0,
                                                     1)})
    return out


def _recorded(module, losses):
    """module.continuous_loss that records each loss it returns."""
    inner = module.continuous_loss

    def record(*args, **kwargs):
        loss, metrics = inner(*args, **kwargs)
        if isinstance(loss, torch.Tensor):
            losses.append(float(loss.detach()))
        else:
            jax.debug.callback(lambda v: losses.append(float(v)), loss)
        return loss, metrics

    return record


def crc32_hash(word: str) -> int:
    """A word's FallbackTokenizer id source, the same in every process."""
    return zlib.crc32(word.encode())


def salt_free_word_ids(monkeypatch):
    """Both packages' FallbackTokenizer take word ids from crc32 instead of
    the salted builtin `hash` (each reads `hash` from its module)."""
    for module in (jtext, ttext):
        monkeypatch.setattr(module, "hash", crc32_hash, raising=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both drivers' 2-step runs: (JAX model, JAX params, JAX losses, port
    params, port losses, port save dir, draws). The patches are undone
    whether the runs end or raise."""
    with pytest.MonkeyPatch.context() as monkeypatch:
        return _runs(monkeypatch, tmp_path_factory)


def _runs(monkeypatch, tmp_path_factory):
    from scripts.octo_train import run as jax_run

    salt_free_word_ids(monkeypatch)
    config = octo_train_config()
    jlosses, losses = [], []
    monkeypatch.setattr(jah, "continuous_loss",
                        _recorded(jah, jlosses))
    # one device, as the draws are computed on it (GSPMD computes the
    # same values on any mesh)
    from hypervla_tpu.parallel import mesh as jmesh
    make_mesh = jmesh.create_mesh
    monkeypatch.setattr(jmesh, "create_mesh",
                        lambda: make_mesh(jax.devices()[:1]))
    jmodel, jparams = jax_run(copy.deepcopy(config), num_steps=STEPS,
                              dataset=FixedDataset())
    draws = jax_step_draws(jmodel, config["seed"], STEPS, BATCH)

    t5 = from_jax_params(jtrainer.build_frozen_encoders(config)[2])
    monkeypatch.setattr(ttrainer, "load_t5_weights",
                        lambda name, device=None: t5)
    monkeypatch.setattr(ah, "continuous_loss", _recorded(ah, losses))
    monkeypatch.setattr(octo_train, "step_draws",
                        lambda seed, step, device, rows=None: Draws(
                            replay=draws[step]))
    init = from_jax_params(flax.core.unfreeze(jmodel.params))
    from_config = octo_train.OctoModel.from_config

    def jax_init(*args, **kwargs):
        model = from_config(*args, **kwargs)
        assert set(model.params) == set(init)
        model.params = init
        return model

    monkeypatch.setattr(octo_train.OctoModel, "from_config", jax_init)
    save_dir = str(tmp_path_factory.mktemp("octo_run"))
    port_config = port_module_specs(copy.deepcopy(config))
    _, params = octo_train.run(port_config, save_dir=save_dir,
                               num_steps=STEPS, dataset=FixedDataset(),
                               device="cpu")
    return (jmodel, flatten_tree(jparams), jlosses, params, losses,
            save_dir, draws)


def test_run_matches_jax(runs):
    """Each step's loss and every final param to 1e-5 (of the largest
    param), but the attention's key biases: softmax ignores a uniform key
    shift, so their exact gradient is 0 and each package steps them by
    its rounding noise, which Adam scales up to a step of up to the LR;
    both packages' key-bias moves stay within one LR a step."""
    jmodel, jparams, jlosses, params, losses, _, _ = runs
    assert len(jlosses) == len(losses) == STEPS
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert set(params) == set(jparams)
    init = flatten_tree(jax.device_get(jmodel.params))
    lr = octo_train_config()["optimizer"]["learning_rate"]["peak_value"]
    scale = max(float(np.abs(np.asarray(v)).max()) for v in jparams.values())
    for name, value in jparams.items():
        if name.endswith("key/bias"):
            for final in (params[name].numpy(), np.asarray(value)):
                move = np.abs(final - np.asarray(init[name])).max()
                assert move <= 1.01 * lr * STEPS, (name, move)
            continue
        np.testing.assert_allclose(params[name].numpy(), np.asarray(value),
                                   rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=name)


#: a salt at which test_run_matches_jax failed while the word ids came from
#: the salted `hash`
FAILING_SALT = "13"


def test_run_matches_jax_at_a_salt_that_failed():
    """test_run_matches_jax in a child process under PYTHONHASHSEED 13, at
    which it failed while the runs' word ids came from `hash`."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST_")}
    env["PYTHONHASHSEED"] = FAILING_SALT
    tests = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", os.path.join(
             "tests", os.path.basename(__file__)) + "::test_run_matches_jax"],
        cwd=os.path.dirname(tests), env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]


def test_run_saves_a_checkpoint_the_port_loads(runs):
    _, _, _, params, _, save_dir, _ = runs
    from hypervla_tpu_torch.models.octo_model import OctoModel

    loaded = OctoModel.load_pretrained(save_dir, device="cpu")
    assert sorted(os.listdir(save_dir)) == [
        str(STEPS), "config.json", "dataset_statistics.json",
        "example_batch.npz"]
    for name, value in params.items():
        assert torch.equal(loaded.params[name], value), name
    with open(os.path.join(save_dir, "config.json")) as f:
        assert json.load(f)["model"]["heads"]["action"]["module"] == (
            "hypervla_tpu_torch.models.action_heads")


def test_one_rank_group_is_bit_equal_to_none(tmp_path):
    """The driver's step without a process group and then inside a gloo
    group of one rank (in this process), on the port's own init and
    draws: the same params bit for bit."""
    import torch.distributed as dist

    config = port_module_specs(octo_train_config())
    _, alone = octo_train.run(copy.deepcopy(config), num_steps=1,
                              dataset=FixedDataset(),
                              device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        _, grouped = octo_train.run(copy.deepcopy(config), num_steps=1,
                                    dataset=FixedDataset(),
                                    device="cpu")
    finally:
        dist.destroy_process_group()
    for name, value in alone.items():
        assert torch.equal(grouped[name], value), name


# ------------------------ HyperVLA with the Octo base net ------------------------


def _octo_change(config, share=True, package="hypervla_tpu"):
    config["base_net_kwargs"]["model_type"] = "octo"
    config["hypernet_kwargs"]["share_layer_index"] = share
    config["model"]["token_embedding_size"] = 16
    config["model"]["transformer_kwargs"] = dict(
        num_layers=1, mlp_dim=32, num_attention_heads=2, dropout_rate=0.0,
        attention_dropout_rate=0.0, add_position_embedding=False,
        learnable_norm=True)
    config["model"]["observation_tokenizers"] = {"primary": {
        "module": f"{package}.models.tokenizers", "name": "ImageTokenizer",
        "args": (), "kwargs": {
            "obs_stack_keys": ["image_primary"],
            "encoder": {"module": f"{package}.models.vit_encoders",
                        "name": "SmallStem16", "args": (),
                        "kwargs": {"num_features": 16}}}}}
    return config


def _configs(share=True, head="mix"):
    jconfig = _octo_change(jax_tiny_config(action_head_type=head), share)
    config = tiny_test_config("SmallStem", head)
    config["model"] = port_module_specs(copy.deepcopy(jconfig["model"]))
    config["base_net_kwargs"]["model_type"] = "octo"
    config["hypernet_kwargs"]["share_layer_index"] = share
    return jconfig, config


@pytest.fixture(scope="module")
def octo_pair():
    jconfig, config = _configs()
    batch = make_example_batch(batch_size=2, image_size=64)
    jmodel = JaxHyperVLA.from_config(jconfig, batch, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def nudge(path, x):
        x = np.asarray(x, np.float32)
        name = "/".join(str(p.key) for p in path)
        if name.startswith("output_head") and name.endswith("kernel"):
            x = x + rng.standard_normal(x.shape).astype(np.float32) * (
                np.float32(0.05))
        return x

    params = jax.tree_util.tree_map_with_path(
        nudge, flax.core.unfreeze(jmodel.params))
    jmodel = jmodel.replace(params=params)
    model = HyperVLA.from_config(config, batch, device="cpu")
    ported = from_jax_params(params)
    assert set(ported) == set(model.params)
    for name, value in model.params.items():
        assert ported[name].shape == value.shape, name
    model.params = ported
    return jmodel, jconfig, model, config, batch


def test_hypervla_octo_plan_matches_jax(octo_pair):
    jmodel, _, model, _, _ = octo_pair
    flags = flatten_tree(jax.device_get(
        jmodel.hypernet.base_net_metadata["generation_flag"]))
    assert sorted(model.plan.names) == sorted(flags)
    assert all(model.plan.generation_flag[n] == bool(flags[n])
               for n in flags)
    assert model.plan.layer_token_mask == (True,)


def test_hypervla_octo_loss_matches_the_jax_step(octo_pair):
    jmodel, jconfig, model, config, batch = octo_pair
    ref = jax_reference(jmodel, jconfig, batch,
                        dropout_keys(jax.random.PRNGKey(0), 2))
    info, grads = port_step_grads(model, config, to_tensors(batch, "cpu"),
                                  None)
    assert abs(info["training_loss"] - ref["loss"]) <= 1e-5 * ref["loss"]
    assert_grads_close(grads, ref["grads"])


def test_hypervla_octo_serving_raises_type_error_as_in_jax(octo_pair):
    jmodel, _, model, _, batch = octo_pair
    instruction = {"language_instruction": batch["task"][
        "language_instruction"]}
    one = jax.tree_util.tree_map(lambda x: np.asarray(x)[:1], batch)
    jbase, jtask, _ = jmodel.create_tasks(instruction_dict=jax.tree_util
                                          .tree_map(lambda x: x[:1],
                                                    instruction))
    with pytest.raises(TypeError, match="image_embeddings"):
        jmodel.sample_actions(one["observation"]["image_primary"],
                              instruction, jtask,
                              one["observation"]["timestep_pad_mask"], jbase,
                              rng=jax.random.PRNGKey(1))
    base, task = model.create_tasks(instruction_dict=jax.tree_util.tree_map(
        lambda x: x[:1], instruction))
    with pytest.raises(TypeError, match="image_embeddings"):
        model.sample_actions(one["observation"]["image_primary"],
                             instruction, task, None, base)


def test_hypervla_octo_without_share_layer_index_raises_key_error():
    jconfig, config = _configs(share=False)
    batch = make_example_batch(image_size=64)
    with pytest.raises(KeyError, match="SmallStem_0"):
        JaxHyperVLA.from_config(jconfig, batch, jax.random.PRNGKey(0))
    with pytest.raises(KeyError, match="SmallStem_0"):
        HyperVLA.from_config(config, batch, device="cpu")


def test_hypervla_octo_diffusion_builds_and_trains():
    """The diffusion head over the tiny Octo base net (42,278,030
    params, as the JAX init of the same config) builds, and a port step
    runs."""
    jconfig, config = _configs(head="diffusion")
    batch = make_example_batch(batch_size=2, image_size=64)
    model = HyperVLA.from_config(config, batch, device="cpu")
    assert sum(v.numel() for v in model.params.values()) == 42278030
    info, _ = port_step_grads(model, config, to_tensors(batch, "cpu"),
                              Draws(torch.Generator().manual_seed(0)))
    assert np.isfinite(info["training_loss"])
