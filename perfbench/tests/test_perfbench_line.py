"""The result line and the window's arithmetic, on the CPU at the tiny
twins: exactly the contract's keys, the checks last, a compact line; all
the work over all the time; the 95th percentile over every request; a
metric with nothing to read left out, never 0."""
import json
import statistics
import time

import pytest

from perfbench.harness import cell
from perfbench.harness.replay_driver import p95
from perfbench.tests.tiny import (
    TINY_LIMITS,
    TINY_TRAIN_MIX,
    tiny_flagship,
    tiny_replay_mix,
    tiny_smallstem,
)

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def tiny_files(workload):
    """The cell's files with its configuration, mix and limits at the tiny
    twin."""
    files = cell.cell_files(cell.manifest(), workload)
    if workload.startswith("smallstem"):
        files["config"] = tiny_smallstem()
    else:
        files["config"] = tiny_flagship()
    files["mix"] = (tiny_replay_mix() if "replay" in workload
                    else dict(TINY_TRAIN_MIX))
    files["limits"] = dict(TINY_LIMITS[workload])
    return files


@pytest.mark.parametrize("workload", ["flagship.train_b256",
                                      "smallstem.train_b256",
                                      "flagship.replay_b256"])
def test_line_keys_and_size(workload):
    files = tiny_files(workload)
    line = cell.run_cell(workload, 2 ** 31 + 5, 0.3, False,
                         time.perf_counter(), "cpu", files=files)
    assert list(line) == KEYS
    assert line["correct"] is True
    assert set(line["metrics"]) == {m["name"] for m in files["end_to_end"]}
    for metric in line["metrics"].values():
        assert set(metric) == {"value", "unit"} and metric["value"] > 0 \
            or metric["unit"] == "GiB"
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["checks"]) == set(files["limits"])
    text = json.dumps(line, separators=(",", ":"))
    assert len(text) < 1500


def test_traced_line_leaves_out_what_it_cannot_read():
    """On the CPU the trace holds no device record: every device-trace
    metric is missing (not 0), and the line has no busy_s or breakdown."""
    files = tiny_files("flagship.train_b256")
    line = cell.run_cell("flagship.train_b256", 7, 0.3, True,
                         time.perf_counter(), "cpu", files=files)
    assert list(line) == KEYS
    assert set(line["metrics"]) == {"mfu.train"}
    assert "busy_s" not in line["device"]


def test_train_window_counts_all_steps_over_all_time():
    files = tiny_files("flagship.train_b256")
    drv = cell.driver_for("train")(files["config"], files["mix"], 1, "cpu")
    steps = []
    drv.step = lambda: (time.sleep(0.02), steps.append(1))
    synced = []
    out = drv.run(0.2, lambda: synced.append(time.perf_counter()))
    assert out["units"] == len(steps) >= 9
    assert len(synced) == 2
    assert out["window_s"] >= 0.2
    assert out["metrics"]["train_samples_per_s"] == pytest.approx(
        len(steps) * files["mix"]["batch_size"] / out["window_s"])


def test_replay_tail_is_over_every_request():
    values = [float(v) for v in range(1, 201)]
    assert p95(values) == statistics.quantiles(values, n=20)[18]
    assert 190 < p95(values) < 191
