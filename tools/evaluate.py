#!/usr/bin/env python3
"""Evaluation fan-out CLI of the port (the flags of the JAX package's
scripts/evaluate.py).

Launches per-seed closed-loop evaluation runs (SIMPLER or LIBERO) as child
processes, `python -m hypervla_tpu_torch.eval.simpler` or `.libero`: a
declarative flag-spec table drives `subprocess` list-argv commands (no
shell string interpolation).

    python tools/evaluate.py --benchmark simpler --folder <checkpoint> \
        --step_num <N> --seed_num 3
    python tools/evaluate.py --benchmark libero_object --folder <checkpoint>
"""
import argparse
import subprocess
import sys

# Each spec row: (CLI attr on args, child flag, kind).
#   kind "value"  -> emit `flag value` when the attr is not None
#   kind "switch" -> emit bare `flag` when the attr is truthy
_COMMON_SPECS = [
    ("recompute", "--recompute", "switch"),
    ("EMA", "--EMA", "value"),
    ("policy_server", "--policy_server", "value"),
]
_SIMPLER_SPECS = [
    ("method", "--model", "value"),
    ("folder", "--model_path", "value"),
    ("step_num", "--step", "value"),
    ("window_size", "--window_size", "value"),
    ("action_ensemble", "--action_ensemble", "switch"),
    ("save_video", "--save_video", "switch"),
    ("crop", "--crop", "switch"),
] + _COMMON_SPECS
_LIBERO_SPECS = [
    ("folder", "--model_path", "value"),
    ("step_num", "--step", "value"),
    ("benchmark", "--benchmark", "value"),
    ("split", "--split", "value"),
    ("split_file", "--split_file", "value"),
] + _COMMON_SPECS


def build_argv(module, specs, options, seed):
    """One child command as an argv list: `python -m <module> <flags>`."""
    argv = [sys.executable, "-m", module, "--seeds", str(seed)]
    for attr, flag, kind in specs:
        value = options.get(attr)
        if kind == "switch":
            if value:
                argv.append(flag)
        elif value is not None:
            argv.extend([flag, str(value)])
    return argv


def run_seeds(module, specs, options, seed_num, parallel=False):
    """Runs one child per seed; parallel=True overlaps them."""
    procs = []
    for seed in range(seed_num):
        argv = build_argv(module, specs, options, seed)
        proc = subprocess.Popen(argv)
        if parallel:
            procs.append(proc)
        else:
            proc.wait()
    for proc in procs:
        proc.wait()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--benchmark", type=str, default="simpler",
                        help="'simpler' or a LIBERO suite name")
    parser.add_argument("--method", type=str, default="hypervla")
    parser.add_argument("--folder", type=str, default="")
    parser.add_argument("--step_num", type=int, default=100000)
    parser.add_argument("--seed_num", type=int, default=3)
    parser.add_argument("--save_video", action="store_true")
    parser.add_argument("--window_size", type=int, default=2)
    parser.add_argument("--recompute", action="store_true")
    parser.add_argument("--action_ensemble", action="store_true")
    parser.add_argument("--crop", action="store_true")
    parser.add_argument("--parallel_eval", action="store_true")
    parser.add_argument("--EMA", type=float, default=None)
    parser.add_argument("--policy_server", type=str, default=None,
                        help="host:port of a policy server")
    parser.add_argument("--split", type=str, default=None,
                        help="libero_90 split (train/test/single_task)")
    parser.add_argument("--split_file", type=str, default=None)
    args = parser.parse_args(argv)

    options = vars(args).copy()
    if args.benchmark == "simpler":
        run_seeds("hypervla_tpu_torch.eval.simpler", _SIMPLER_SPECS, options,
                  args.seed_num, parallel=args.parallel_eval)
    else:
        if options["EMA"] is None:
            options["EMA"] = 0.999
        run_seeds("hypervla_tpu_torch.eval.libero", _LIBERO_SPECS, options,
                  args.seed_num)


if __name__ == "__main__":
    main()
