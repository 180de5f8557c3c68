"""The port's trainer (hypervla_tpu_torch/train/trainer.py, callbacks.py,
main.py) as a whole, against the JAX package's trainer on the CPU.

Both trainers read one fixture written here (npz trajectories of 224x224
JPEG frames, one of the two instructions a drawer task, so per-task losses
are logged) with the tiny DINOv2 configs: the port's tiny_test_config() and
the JAX tiny_test_config(encoder_type="DINOv2"). They start from the same
weights: the JAX trainer, run for 0 steps with save_param_EMA, writes step
0 with its EMA pickle; tools/convert_checkpoint_to_torch.py converts it; both
warm-start from it. The frozen T5 and DINOv2 are the JAX trainer's PRNGKey(0)
init, handed to the port as `$HYPERVLA_PRETRAINED_DIR/<name>.pt`. Both
pipelines tokenize with FallbackTokenizer, in this one process.

Then three steps each: training_loss and the task_loss_* entries agree per
step to 1e-5 relative, the final params as tests/test_torch_train_step.py
holds one step (updates at cosine > 0.999, EMA to 1e-5). Also: resume from
state/latest.pt bit for bit, the trained checkpoint serving a finite action,
the command line, device augmentation, and the refusals of the unported
paths. Every call passes the CPU: the port's default is the card."""
import copy
import io
import itertools
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from hypervla_tpu.configs import tiny_test_config as jax_tiny_config
from hypervla_tpu.data.sources import NpzTrajectorySource
from hypervla_tpu.train import trainer as jtrainer
from hypervla_tpu_torch.configs import tiny_test_config
from hypervla_tpu_torch.eval.model_loading import (
    build_text_encoder,
    load_hypervla_policy,
)
from hypervla_tpu_torch.models.hypervla import EMA_FILE, PARAMS_FILE
from hypervla_tpu_torch.train import trainer
from hypervla_tpu_torch.train.callbacks import STATE_FILE, SaveCallback
from hypervla_tpu_torch.train.main import apply_overrides, load_config, main
from hypervla_tpu_torch.train.train_step import (
    augment_generator,
    augment_specs,
    device_augment,
)
from hypervla_tpu_torch.utils.convert import flatten_tree, from_jax_params
from test_torch_data_pipeline import assert_tree_equal
from tools.convert_checkpoint_to_torch import convert

STEPS = 3
INSTRUCTIONS = [b"close top drawer", b"pick up the block"]
CHAIN = dict(
    augment_order=["random_resized_crop", "random_brightness",
                   "random_contrast", "random_saturation", "random_hue"],
    random_resized_crop=dict(scale=[0.8, 1.0], ratio=[0.9, 1.1]),
    random_brightness=[0.1], random_contrast=[0.9, 1.1],
    random_saturation=[0.9, 1.1], random_hue=[0.05])


def _jpeg(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG")
    return buf.getvalue()


class Recorder:
    """A stand-in for a wandb run: the logged dicts by step."""

    def __init__(self):
        self.logs = {}

    def log(self, metrics, step):
        self.logs.setdefault(step, {}).update(metrics)


def _dataset_kwargs(root):
    return {
        "batch_size": 8,  # the JAX mesh has 8 CPU devices
        "shuffle_buffer_size": 16,
        "text_tokenizer": "t5-base",
        "tokenizer_max_length": 8,
        "resize_size": {"primary": (224, 224)},
        "dataset_kwargs_list": [dict(
            name="fixture_train", data_dir=root,
            image_obs_keys={"primary": "image"},
            language_key="language_instruction",
            action_proprio_normalization_type="normal",
            add_initial_image=True)],
    }


def _settings(config, root):
    config["dataset_kwargs"] = _dataset_kwargs(root)
    config["optimizer"]["learning_rate"] = {
        "name": "rsqrt", "init_value": 0.0, "peak_value": 3e-4,
        "warmup_steps": 1, "timescale": 10000}
    config.update(log_interval=1, save_interval=1000, save_param_EMA=True,
                  EMA_start_step=0, seed=7)
    return config


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The fixture, the frozen encoders' weights and the step-0 checkpoint
    in both formats. The JAX trainer's frozen encoders are built once for
    the file (a deterministic PRNGKey(0) init) and handed to each of its
    runs."""
    with pytest.MonkeyPatch.context() as mp:
        encoders = jtrainer.build_frozen_encoders(
            _settings(jax_tiny_config(encoder_type="DINOv2"), ""))
        mp.setattr(jtrainer, "build_frozen_encoders",
                   lambda config: encoders)
        yield _setup(tmp_path_factory, encoders)


def _setup(tmp_path_factory, encoders):
    root = tmp_path_factory.mktemp("trainer")
    data = str(root / "data")
    rng = np.random.RandomState(0)
    os.makedirs(os.path.join(data, "fixture_train"))
    for ep in range(4):
        n = 8
        NpzTrajectorySource.write_trajectory(
            os.path.join(data, "fixture_train", f"ep_{ep:03d}.npz"),
            {"observation": {"image": np.array(
                [_jpeg(rng.randint(0, 255, (224, 224, 3)).astype(np.uint8))
                 for _ in range(n)], dtype=object)},
             "action": rng.randn(n, 7).astype(np.float32),
             "language_instruction": np.array([INSTRUCTIONS[ep % 2]] * n,
                                              dtype=object)})
    jconfig = _settings(jax_tiny_config(encoder_type="DINOv2"), data)
    _, _, t5, dino = encoders
    pretrained = root / "pretrained"
    os.makedirs(pretrained)
    torch.save(from_jax_params(jax.tree_util.tree_map(np.asarray, t5)),
               pretrained / "t5-base.pt")
    torch.save(from_jax_params(jax.tree_util.tree_map(np.asarray, dino)),
               pretrained / "dinov2-test.pt")
    jdir, tdir = str(root / "jax_init"), str(root / "torch_init")
    jtrainer.train(copy.deepcopy(jconfig), save_dir=jdir, num_steps=0)
    assert convert(jdir, tdir, step=0) == [0]
    return dict(root=root, data=data, jconfig=jconfig, jdir=jdir, tdir=tdir,
                pretrained=str(pretrained))


@pytest.fixture
def pretrained_dir(setup, monkeypatch):
    monkeypatch.setenv("HYPERVLA_PRETRAINED_DIR", setup["pretrained"])


def _port_config(setup, **changes):
    config = _settings(tiny_test_config(), setup["data"])
    config.update(pretrained_checkpoint_path=setup["tdir"],
                  pretrained_checkpoint_step=0)
    config.update(changes)
    return config


def _cosine(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    n = np.linalg.norm(a) * np.linalg.norm(b)
    return 1.0 if n == 0 and np.allclose(a, b) else float(a @ b / n)


def test_trainer_matches_jax(setup, pretrained_dir, tmp_path):
    """Three steps of each trainer from the same warm start: per-step
    losses and per-task losses to 1e-5 relative, the final params' updates
    at cosine > 0.999 and the EMA to 1e-5."""
    jconfig = copy.deepcopy(setup["jconfig"])
    jconfig.update(pretrained_checkpoint_path=setup["jdir"],
                   pretrained_checkpoint_step=0)
    jlog, log = Recorder(), Recorder()
    jstate = jtrainer.train(jconfig, num_steps=STEPS, wandb_run=jlog)
    save_dir = str(tmp_path / "run")
    state = trainer.train(_port_config(setup), save_dir=save_dir,
                          num_steps=STEPS, wandb_run=log, device="cpu")
    assert state.step == STEPS and set(log.logs) == set(range(1, STEPS + 1))
    for step in range(1, STEPS + 1):
        got, ref = log.logs[step], jlog.logs[step]
        keys = ["training_loss"] + [k for k in ref if k.startswith("task_")]
        assert "task_loss_close top drawer" in keys
        assert set(k for k in got if k.startswith("task_")) == set(keys[1:])
        for key in keys:
            np.testing.assert_allclose(got[key], float(ref[key]), rtol=1e-5,
                                       err_msg=f"step {step} {key}")
        assert got["task_loss_close middle drawer"] == 0.0
        assert {"timer/dataset", "timer/train", "timer/total"} <= set(got)

    init = torch.load(os.path.join(setup["tdir"], "0", EMA_FILE),
                      weights_only=True)["EMA_0.999"]
    ref_params = flatten_tree(jax.device_get(jstate.params))
    ref_ema = flatten_tree(jax.device_get(jstate.ema_params))
    assert set(state.params) == set(ref_params)
    typical = np.median([np.linalg.norm(np.asarray(ref_params[k])
                                        - init[k].numpy())
                         for k in ref_params])
    bad = []
    for name, ref in ref_params.items():
        old = init[name].numpy()
        got_u = state.params[name].detach().numpy() - old
        ref_u = np.asarray(ref) - old
        if "key_bias" in name:
            # the key bias's exact gradient is 0 (softmax ignores a uniform
            # key shift): both steps move it by rounding noise, which
            # Adam's normalisation scales up; the port's must stay as small
            ok = max(np.linalg.norm(got_u),
                     np.linalg.norm(ref_u)) < 0.1 * typical
        elif np.linalg.norm(ref_u) < 1e-3 * typical:
            ok = np.linalg.norm(got_u) < 1e-2 * typical
        else:
            ok = _cosine(got_u, ref_u) > 0.999
        if not ok:
            bad.append((name, _cosine(got_u, ref_u), np.linalg.norm(got_u),
                        np.linalg.norm(ref_u), typical))
        np.testing.assert_allclose(state.ema_params[name].numpy(),
                                   np.asarray(ref_ema[name]), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    assert not bad, bad

    # the trained checkpoint, as a user serves it
    for name in (PARAMS_FILE, EMA_FILE):
        assert os.path.exists(os.path.join(save_dir, str(STEPS), name))
    policy = load_hypervla_policy(save_dir, image_size=224, crop=False,
                                  device="cpu")
    encode = build_text_encoder(policy.model, device="cpu")
    frame = np.random.default_rng(0).integers(0, 256, (224, 224, 3),
                                              dtype=np.uint8)
    _, dino_apply, _, dino_params = trainer.build_frozen_encoders(
        policy.model.config, device="cpu")
    with torch.no_grad():
        patches = dino_apply(dino_params, torch.tensor(frame)[None])
    policy.reset("close top drawer", encode("close top drawer"),
                 {"patch_embeddings": patches.numpy()})
    _, action, *_ = policy.step(frame)
    assert action.shape == (7,) and np.isfinite(action).all()


def _assert_state_equal(got, want):
    assert got.step == want.step and got.seed == want.seed
    for a, b in ((got.params, want.params), (got.ema_params, want.ema_params),
                 (got.opt_state["mu"], want.opt_state["mu"]),
                 (got.opt_state["nu"], want.opt_state["nu"])):
        assert set(a) == set(b)
        for k in b:
            assert a[k].dtype == b[k].dtype and torch.equal(
                a[k].detach(), b[k].detach()), k
    assert got.opt_state["count"] == want.opt_state["count"]


def test_save_and_resume_bit_for_bit(setup, pretrained_dir, tmp_path):
    """A run of 1 step, then one of 2 from the same save_dir: the second
    resumes at 1 and ends at 2; the state read back from state/latest.pt
    is the saved one bit for bit."""
    save_dir = str(tmp_path / "resume")
    config = _port_config(setup, save_interval=1, eval_datasets=[
        "fixture_train"], eval_interval=1)
    log = Recorder()
    first = trainer.train(copy.deepcopy(config), save_dir=save_dir,
                          num_steps=1, wandb_run=log, device="cpu")
    mse = log.logs[1]["validation/fixture_train/mse"]
    assert np.isfinite(mse) and mse > 0
    assert os.path.exists(os.path.join(save_dir, "state", STATE_FILE))
    blank = copy.deepcopy(first)
    blank.step = 0
    restored, step = SaveCallback(save_dir).restore(blank)
    assert step == 1
    _assert_state_equal(restored, first)
    assert all(p.requires_grad for p in restored.params.values())
    second = trainer.train(copy.deepcopy(config), save_dir=save_dir,
                           num_steps=2, device="cpu")
    assert second.step == 2 and second.opt_state["count"] == 2
    _assert_state_equal(SaveCallback(save_dir).restore(blank)[0], second)


def test_command_line_runs_a_config_file(setup, pretrained_dir, tmp_path):
    """`main` on a config file whose get_config returns a dict, with
    overrides of existing fields; the built-in string is the port's copy of
    scripts/configs/hypervla_pretrain_config.py."""
    config = _port_config(setup)
    path = tmp_path / "config.py"
    path.write_text(f"def get_config(s):\n    return {config!r}\n")
    save_dir = str(tmp_path / "cli")
    state = main(["--config", f"{path}:x", "--save_dir", save_dir, "--cpu",
                  "--config.num_steps=1", "--config.seed=3"])
    assert state.step == 1 and state.seed == 3
    assert os.path.exists(os.path.join(save_dir, "1", PARAMS_FILE))

    fast = load_config("vit_t,oxe,fast")
    assert fast["dataset_kwargs"]["oxe_mix"] == "oxe_magic_soup"
    assert fast["base_net_kwargs"]["vit_kwargs"]["encoder_dtype"] == (
        "bfloat16") and fast["frozen_encoder_layer_kernel"]
    for name in ("hypervla_pretrain_config",
                 "scripts/configs/hypervla_pretrain_config.py"):
        assert load_config(f"{name}:vit_t,oxe,fast") == fast
    with pytest.raises(ValueError, match="neither a .py file"):
        load_config("no_such_config:vit_t,oxe")
    apply_overrides(fast, ["--config.dataset_kwargs.data_dir=/data/oxe",
                           "--config.dataset_kwargs.batch_size=64"])
    assert fast["dataset_kwargs"]["data_dir"] == "/data/oxe"
    assert fast["dataset_kwargs"]["batch_size"] == 64
    with pytest.raises(KeyError, match="no such field"):
        apply_overrides(fast, ["--config.dataset_kwargs.no_field=1"])


def test_device_augment_runs_and_repeats(setup, pretrained_dir):
    """device_augment: the host only resizes, the step augments each
    camera's frames from a generator of (seed, step): not the identity, the
    same under the same seed and step, different at another step; a step
    of the trainer runs with it."""
    config = _port_config(setup)
    config["dataset_kwargs"].update(device_augment=True,
                                    image_augment_kwargs=CHAIN)
    specs = augment_specs(config)
    assert specs == {"primary": CHAIN}
    frames = torch.randint(0, 256, (4, 1, 224, 224, 3), dtype=torch.uint8)

    def augmented(step):
        batch = {"observation": {"image_primary": frames.clone()}}
        device_augment(batch, specs, augment_generator(7, step, "cpu"))
        return batch["observation"]["image_primary"]

    a = augmented(5)
    assert a.shape == frames.shape and a.dtype == torch.uint8
    assert not torch.equal(a, frames)
    assert torch.equal(a, augmented(5)) and not torch.equal(a, augmented(6))
    log = Recorder()
    state = trainer.train(config, num_steps=1, wandb_run=log, device="cpu")
    assert state.step == 1 and np.isfinite(log.logs[1]["training_loss"])


@pytest.mark.parametrize("change,kwargs,item", [
    (dict(viz_datasets=["fixture_train"]), {}, "A12.3"),
    ({}, dict(fsdp=2), "A11"),
    ({}, dict(tp=2), "A11"),
    ({}, dict(profile_dir="/nonexistent"), "A11"),
])
def test_unported_paths_raise(setup, change, kwargs, item):
    config = _port_config(setup, **change)
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        trainer.train(config, num_steps=1, device="cpu", **kwargs)


def test_train_defaults_to_the_card(setup):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is that card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.train(_port_config(setup), num_steps=1)


def test_jax_step0_checkpoint_is_the_warm_start(setup):
    """The converted step-0 EMA is the JAX pickle, bit for bit."""
    with open(os.path.join(setup["jdir"], "0", "EMA_params.pkl"), "rb") as f:
        ref = from_jax_params(pickle.load(f)["EMA_0.999"])
    got = torch.load(os.path.join(setup["tdir"], "0", EMA_FILE),
                     weights_only=True)["EMA_0.999"]
    assert set(got) == set(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


def test_pipeline_process_matches_in_thread(setup):
    """train()'s pipeline in a worker process gives the batches and the
    statistics of the same pipeline run here; close() stops the worker."""
    config = _port_config(setup)
    ref = trainer.make_train_datasets(copy.deepcopy(config))
    pipeline = trainer.PipelineProcess(copy.deepcopy(config))
    try:
        assert_tree_equal(pipeline.dataset_statistics,
                          ref.dataset_statistics)
        for got, want in zip(itertools.islice(pipeline, 3),
                             itertools.islice(ref, 3)):
            assert_tree_equal(got, want)
    finally:
        pipeline.close()
    assert not pipeline._proc.is_alive()


def test_pipeline_process_reports_worker_errors(setup, tmp_path):
    config = _port_config(setup)
    config["dataset_kwargs"]["dataset_kwargs_list"][0]["data_dir"] = str(
        tmp_path / "missing")
    with pytest.raises(RuntimeError, match="FileNotFoundError"):
        trainer.PipelineProcess(config)
