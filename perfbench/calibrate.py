"""Readings for the limits of a cell's comparison, on the card at the
cell's own size, many seeds in one process: the program's (against the
reference), the control's (the reference in the next lower precision, in
the program's place) and, with --fault, each planted fault's
(perfbench/harness/faults.py). The cell's driver takes them
(perfbench/harness/<kind>_driver.py::calibrate). Not part of a benchmark
run.

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control] [--fault half_batch,unchanged]

Prints one JSON line a seed and kind."""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from perfbench.harness import cell  # noqa: E402


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default="")
    args = p.parse_args()
    files = cell.cell_files(cell.manifest(), args.workload)
    driver = cell.driver_module(files["mix"]["kind"])

    def emit(record):
        record["card"] = torch.cuda.get_device_name(0)
        print(json.dumps(record), flush=True)

    fault_names = list(filter(None, args.fault.split(",")))
    for seed in [int(s) for s in args.seeds.split(",")]:
        driver.calibrate(files, seed, args.control, fault_names, emit)


if __name__ == "__main__":
    main()
