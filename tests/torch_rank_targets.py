"""Targets of parallel/dryrun.py::run_ranks for the port's tests. Spawned
ranks import this module by name, so it imports no JAX (the test files do,
and tests/conftest.py sets up JAX's virtual devices)."""
import io
import os

import numpy as np

from hypervla_tpu_torch.configs import tiny_test_config
from hypervla_tpu_torch.data.sources import NpzTrajectorySource
from hypervla_tpu_torch.parallel.dryrun import mesh_steps, to_numpy
from hypervla_tpu_torch.parallel.mesh import process_index

INSTRUCTIONS = [b"close top drawer", b"pick up the block"]


class Recorder:
    """A stand-in for a wandb run: the logged dicts by step."""

    def __init__(self):
        self.logs = {}

    def log(self, metrics, step):
        self.logs.setdefault(step, {}).update(metrics)


def train_main(rank, world, argv):
    """The training command line on every rank of the group; returns rank
    0's logged metrics by step (None elsewhere), the final state's step and
    its params, whole."""
    from hypervla_tpu_torch.train import main as cli

    recorder = Recorder()
    cli._wandb_run = lambda args, config: (
        recorder if process_index() == 0 else None)
    state = cli.main(argv)
    return {"logs": recorder.logs if process_index() == 0 else None,
            "step": state.step, "params": to_numpy(state.params)}


def train_profiled(rank, world, config, save_dir, profile_dir,
                   profile_steps):
    """train() on the CPU with the profile window, as main() runs it;
    returns train_main's fields and rank 0's logged profile lines."""
    import logging

    from hypervla_tpu_torch.train import trainer

    lines = []

    class Lines(logging.Handler):
        def emit(self, record):
            if record.getMessage().startswith("profile"):
                lines.append(record.getMessage())

    logging.getLogger().setLevel(logging.INFO)
    logging.getLogger().addHandler(Lines())
    recorder = Recorder()
    state = trainer.train(config, save_dir=save_dir, wandb_run=recorder,
                          profile_dir=profile_dir,
                          profile_steps=profile_steps, device="cpu")
    return {"logs": recorder.logs, "step": state.step,
            "params": to_numpy(state.params), "lines": lines}


def steps_and_agreement(rank, world, jobs):
    """mesh_steps(jobs), then the trainer's check that every rank's
    pipeline gave the same first batch, on batches that agree and on
    batches whose token ids differ by rank (as a tokenizer that hashes
    words gives them under different hash seeds); returns (mesh_steps'
    results, the error message of the second check or None)."""
    import torch

    from hypervla_tpu_torch.train.trainer import _check_ranks_agree

    out = mesh_steps(rank, world, jobs)
    ids = np.arange(32, dtype=np.int32).reshape(4, 8)
    batch = {"task": {"language_instruction": {"input_ids": ids}},
             "action": np.ones((4, 1, 2, 7), np.float32)}
    _check_ranks_agree(batch, torch.device("cpu"))
    batch["task"]["language_instruction"]["input_ids"] = ids + (rank > 0)
    try:
        _check_ranks_agree(batch, torch.device("cpu"))
        refused = None
    except RuntimeError as e:
        refused = str(e)
    return out, refused


def _jpeg(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG")
    return buf.getvalue()


def write_fixture_config(root, steps):
    """A fixture dataset of 4 trajectories of 8 JPEG frames under root, half
    of them a drawer task, and the tiny DINOv2 flagship's config over it at
    batch 8 for `steps` steps, written to root/config.py; returns
    {"config", "path", "root"}."""
    data = os.path.join(str(root), "data")
    os.makedirs(os.path.join(data, "fixture_train"))
    rng = np.random.RandomState(0)
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
    config = tiny_test_config()
    config["dataset_kwargs"] = {
        "batch_size": 8, "shuffle_buffer_size": 16,
        "text_tokenizer": "t5-base", "tokenizer_max_length": 8,
        "resize_size": {"primary": (224, 224)},
        "dataset_kwargs_list": [dict(
            name="fixture_train", data_dir=data,
            image_obs_keys={"primary": "image"},
            language_key="language_instruction",
            action_proprio_normalization_type="normal",
            add_initial_image=True)]}
    config["optimizer"]["learning_rate"] = {
        "name": "rsqrt", "init_value": 0.0, "peak_value": 3e-4,
        "warmup_steps": 1, "timescale": 10000}
    config.update(log_interval=1, save_interval=1000, save_param_EMA=True,
                  EMA_start_step=0, seed=7, num_steps=steps)
    path = os.path.join(str(root), "config.py")
    with open(path, "w") as f:
        f.write(f"def get_config(s):\n    return {config!r}\n")
    return {"config": config, "path": path, "root": root}


def argv(fixture, save_dir, *extra):
    """The command line of a run over write_fixture_config's config."""
    return ["--config", f"{fixture['path']}:x", "--save_dir", save_dir,
            "--cpu", *extra]
