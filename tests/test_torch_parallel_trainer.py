"""The port's trainer under a process group (hypervla_tpu_torch/train/
trainer.py, main.py) on the CPU:

  * `main([...])` on 2 gloo ranks in spawned processes against train() on
    1 rank, as main runs it, on a fixture of npz trajectories written here:
    each rank runs its own pipeline process, which yields the global batch
    from the same seed, and keeps its rows, so the 2 ranks' per-step
    losses and per-task losses are the 1 rank's (rtol 2e-4, atol 1e-5, the
    JAX package's bound between meshes) and so are the final params, up
    to the reduction order (each element within the step of lr a step that
    Adam may take either way on a gradient within rounding of zero, their
    mean within 1e-6); rank 0 writes the checkpoint, which holds the whole
    params. Both runs spawn their ranks under one PYTHONHASHSEED: the
    fallback tokenizer hashes words, and the trainer refuses ranks whose
    first batches differ (tests/test_torch_parallel_step.py);
  * the profile window of that 1-rank run, profile_steps=(1, 3): its
    chrome trace and each operator's ms per step logged (on the CPU no
    device kernel runs; on the card the kernels, chip_smoke.py's
    multi_device_phase).
"""
import json
import os

import numpy as np
import pytest
import torch

from hypervla_tpu_torch.models.hypervla import PARAMS_FILE
from hypervla_tpu_torch.parallel.dryrun import run_ranks
from test_torch_harness import within
from test_torch_harness import torch_threads  # noqa: F401
from torch_rank_targets import (
    argv,
    train_main,
    train_profiled,
    write_fixture_config,
)

STEPS = 3
PROFILE_STEPS = (1, 3)
#: seconds a run that waits on spawned ranks and pipelines may take
DEADLINE = 600


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The command line on 2 ranks (fsdp 2) and train() on 1 rank with the
    profile window, over one fixture, each rank spawned under
    PYTHONHASHSEED=0 and HF_HUB_OFFLINE=1 (the tokenizer falls back without
    asking the network)."""
    root = tmp_path_factory.mktemp("parallel_trainer")
    fixture = write_fixture_config(root, STEPS)
    with pytest.MonkeyPatch.context() as mp:
        for name, value in (("PYTHONHASHSEED", "0"), ("HF_HUB_OFFLINE", "1"),
                            ("TRANSFORMERS_OFFLINE", "1")):
            mp.setenv(name, value)
        two = within(DEADLINE, run_ranks, 2, train_main,
                     argv(fixture, str(root / "two"), "--fsdp", "2"))
        one = within(DEADLINE, run_ranks, 1, train_profiled,
                     fixture["config"], str(root / "one"),
                     str(root / "profile"), PROFILE_STEPS)
    return dict(fixture=fixture, root=root, two=two, one=one)


def test_main_on_two_ranks_is_the_one_rank_run(runs):
    two, one, root = runs["two"], runs["one"], runs["root"]
    two_dir, one_dir = str(root / "two"), str(root / "one")
    assert [r["step"] for r in two + one] == [STEPS] * 3
    assert two[1]["logs"] is None  # rank 1 logs nothing
    logs2, logs1 = two[0]["logs"], one[0]["logs"]
    assert sorted(logs2) == sorted(logs1) == list(range(1, STEPS + 1))
    for step in logs1:
        keys = [k for k in logs1[step]
                if k == "training_loss" or k.startswith("task_loss_")]
        assert "task_loss_close top drawer" in keys
        for key in keys:
            np.testing.assert_allclose(logs2[step][key], logs1[step][key],
                                       rtol=2e-4, atol=1e-5,
                                       err_msg=f"step {step} {key}")
    # the final params: both ranks hold the same whole params, the 1-rank
    # run's up to reduction order, which Adam turns into at most a step of
    # either sign (lr a step) where a gradient is within rounding of zero
    p2, p1 = two[0]["params"], one[0]["params"]
    lr = runs["fixture"]["config"]["optimizer"]["learning_rate"][
        "peak_value"]
    diffs = []
    for name, value in p1.items():
        np.testing.assert_array_equal(two[1]["params"][name], p2[name])
        diff = np.abs(p2[name] - value)
        assert diff.max(initial=0.0) <= 2 * STEPS * lr, name
        diffs.append(diff.ravel())
    assert np.concatenate(diffs).mean() < 1e-6
    # each run's checkpoint holds its whole params, rank 0 writing
    for run_dir, params in ((two_dir, p2), (one_dir, p1)):
        saved = torch.load(os.path.join(run_dir, str(STEPS), PARAMS_FILE),
                           weights_only=True)
        assert set(saved) == set(params)
        for name, value in params.items():
            np.testing.assert_array_equal(saved[name].numpy(), value)
    with open(os.path.join(two_dir, "config.json")) as f:
        assert json.load(f)["seed"] == 7


def test_profile_window_writes_its_trace(runs):
    """Steps [1, 3) traced into a chrome trace, and each operator's host ms
    per step over the window's 2 steps logged (no device kernel runs on the
    CPU)."""
    with open(str(runs["root"] / "profile" / "trace_rank0.json")) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    lines = runs["one"][0]["lines"]
    assert lines and all("ms host/step over 2 steps" in line
                         for line in lines)
    assert any("aten::" in line for line in lines)
