"""The comparison that decides `correct`, shown to fail: the control (the
reference in the next lower precision, in the program's place) fails the
cell's limits, and each fault a cell can have, planted under a run that
skips only the look for a card, makes `correct` false. At the tiny twins
on the CPU; the same readings at the cells' sizes were taken on the card
(perfbench/calibrate.py, PERF.md)."""
import time

import pytest

from perfbench.harness import cell, faults
from perfbench.harness.replay_driver import compare as replay_compare
from perfbench.harness.train_driver import compare as train_compare
from perfbench.tests.test_perfbench_line import tiny_files


@pytest.mark.parametrize("workload", ["flagship.train_b256",
                                      "smallstem.train_b256"])
def test_train_control_fails(workload):
    files = tiny_files(workload)
    drv = cell.driver_for("train")(files["config"], files["mix"], 21, "cpu")
    ref = drv.reference()
    drv.ema_changes = {} if files["config"]["config"].get(
        "save_param_EMA") else None
    got = train_compare(drv.reference(lower=True), ref)
    assert any(got[k] > limit for k, limit in files["limits"].items()), got


def test_replay_control_fails():
    files = tiny_files("flagship.replay_b256")
    drv = cell.driver_for("replay")(files["config"], files["mix"], 21,
                                    "cpu")
    drv.setup()
    drv.run(0.3, lambda: None)
    drv.release()
    picked = drv.sampled()
    ref = drv.reference_outputs(picked)
    program = replay_compare(drv.answers_kept, ref, picked)
    control = replay_compare(drv.control_answers(picked), ref, picked)
    limits = files["limits"]
    assert all(program[k] <= lim for k, lim in limits.items()), program
    assert any(control[k] > lim for k, lim in limits.items()), control


@pytest.mark.parametrize("workload,fault", [
    ("flagship.train_b256", "unchanged"),
    ("flagship.train_b256", "half_batch"),
    ("smallstem.train_b256", "unchanged"),
    ("smallstem.train_b256", "half_batch"),
    ("flagship.replay_b256", "altered_answer"),
])
def test_fault_makes_the_run_incorrect(workload, fault):
    files = tiny_files(workload)
    line = cell.run_cell(workload, 33, 0.3, False, time.perf_counter(),
                         "cpu", files=files,
                         wrap_step=faults.FAULTS[fault])
    assert line["correct"] is False, line["checks"]
