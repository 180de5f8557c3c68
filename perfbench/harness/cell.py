"""One run of one cell: set-up, the measured window (or with trace the
traced one), the check against the reference, and the result line.

Everything particular to a configuration, a traffic mix, a per-layer
metric or a cell's limits is found by name in BENCHMARK.json and in the
files it names: perfbench/configs/<config>.json, perfbench/traffic/
<mix>.json (whose "kind" picks the driver), perfbench/metrics/<metric>.py
and perfbench/limits/<workload>.json.

A mix's kind names its driver, perfbench/harness/<kind>_driver.py, whose
`Driver(cfg, mix, seed, device, wrap_step)` has: setup(); run(seconds,
sync) -> {"units", "failed", "metrics": every end-to-end value it
measures, by name}; run_units(n) and work() for the traced run; release(),
which frees the program's state and keeps its answers; and readings(),
the numbers the cell's limits name. The module's calibrate(files, seed,
control, fault_names, emit) gives perfbench/calibrate.py its readings."""
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Callable, Optional

import torch

from perfbench.harness import trace as tracing

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)

#: the contract's set-up time, which every cell reports and this module
#: measures itself: process start to the window
SETUP = "setup_s"

#: the top-level modules that no run may have loaded: JAX, its libraries
#: and the JAX package (compared whole: the port's name begins with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "hypervla_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def cell_files(bench: dict, workload: str) -> dict:
    """The cell's entry, its configuration and mix files, its limits and
    the metrics it reports, by kind."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(ROOT, configs[cell["config"]]["file"])
    mix = load_json(BENCH_DIR, "traffic", f"{cell['traffic']}.json")
    limits = load_json(BENCH_DIR, "limits", f"{workload}.json")

    def reports(metric):
        return workload in metric.get("workloads", [workload])

    return {"cell": cell, "config": cfg, "mix": mix, "limits": limits,
            "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
            "per_layer": [m for m in bench["per_layer"] if reports(m)]}


def reader(name: str) -> Callable:
    """perfbench/metrics/<name>.py's `read`."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver_module(kind: str):
    """perfbench/harness/<kind>_driver.py."""
    return importlib.import_module(f"perfbench.harness.{kind}_driver")


def driver_for(kind: str):
    return driver_module(kind).Driver


def forbidden_modules() -> list:
    loaded = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN))


def device_info(device, chips: int, peak: int) -> dict:
    if torch.device(device).type == "cuda":
        kind = torch.cuda.get_device_name(0)
        platform = "gpu"
    else:
        kind, platform = "cpu", "cpu"
    return {"platform": platform, "kind": kind, "count": chips,
            "memory_peak_bytes": int(peak)}


def sync_fn(device) -> Callable[[], None]:
    if torch.device(device).type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


def peak_bytes(device) -> int:
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated()
    return 0


class Context:
    """What a per-layer reader reads: the traced records (or None), the
    untraced time of the same work (`units` steps or requests), and the
    driver's counts and spans (`work`)."""

    def __init__(self, records, timed_s, units, work, cfg, mix):
        self.records, self.timed_s, self.units = records, timed_s, units
        self.work, self.cfg, self.mix = work, cfg, mix


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t0: float, device="cuda", files: Optional[dict] = None,
             wrap_step=None) -> dict:
    """One run; returns the result line's object (its "checks" last).
    wrap_step plants a fault under the program's step or answer
    (perfbench/harness/faults.py)."""
    files = files or cell_files(manifest(), workload)
    cell, cfg, mix = files["cell"], files["config"], files["mix"]
    sync = sync_fn(device)
    drv = driver_for(mix["kind"])(cfg, mix, seed, device,
                                  wrap_step=wrap_step)
    drv.setup()
    sync()
    setup_s = time.perf_counter() - t0
    setup_peak = peak_bytes(device)
    metrics, breakdown, extra = {}, None, {}
    if not trace:
        window = drv.run(seconds, sync)
        window_peak = peak_bytes(device)
        measured = dict(window["metrics"], **{SETUP: setup_s})
        for m in files["end_to_end"]:
            if m["name"] not in measured:
                raise KeyError(f"the {mix['kind']} driver does not measure "
                               f"{m['name']}")
            metrics[m["name"]] = {"value": measured[m["name"]],
                                  "unit": m["unit"]}
        attempted, failed = window["units"], window["failed"]
    else:
        n = mix["trace_units"]
        sync()
        t = time.perf_counter()
        drv.run_units(n)
        sync()
        timed_s = time.perf_counter() - t
        records = tracing.traced(lambda: drv.run_units(n), device)
        window_peak = peak_bytes(device)
        ctx = Context(records, timed_s, n, drv.work(), cfg, mix)
        for m in files["per_layer"]:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        attempted, failed = 2 * n, 0
        if records is not None:
            extra = {"busy_s": records.busy_s(),
                     "window_s": records.window_s}
            breakdown = {"device_ops": records.top_kernels(),
                         "idle_gaps": records.idle_gaps()}
    info = device_info(device, cell["chips"], max(setup_peak, window_peak))
    info.update(extra)
    drv.release()
    readings = drv.readings()
    checks = {k: [readings[k], lim] for k, lim in files["limits"].items()}
    correct = all(v <= lim for v, lim in checks.values())
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return line


def check_devices(chips: int) -> Optional[str]:
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is False: no card to measure on"
    if torch.cuda.device_count() < chips:
        return (f"the cell asks for {chips} cards, "
                f"{torch.cuda.device_count()} are visible")
    return None


def main(argv, t0: float) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    files = cell_files(manifest(), args.workload)
    problem = check_devices(files["cell"]["chips"])
    if problem:
        print(problem, file=sys.stderr)
        return 2
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                    t0, "cuda", files=files)
    found = forbidden_modules()
    if found:
        print("loaded in this process: " + ", ".join(found)
              + " (no run may load JAX or the JAX package)", file=sys.stderr)
        return 3
    for name, (value, limit) in line["checks"].items():
        print(f"check {name}: {value!r} limit {limit!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line, separators=(",", ":")))
    return 0
