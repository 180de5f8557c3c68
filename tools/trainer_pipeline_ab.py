#!/usr/bin/env python3
"""Times the port's trainer on one CUDA card with its input pipeline three
ways, on the fixture OXE mix of chip_smoke.py's trainer phase (2 datasets x
8 trajectories x 20 frames of 256x256 JPEG, written from a seed) at the
full-width fast preset, batch 64, resize 224:

  materialized  the batches made beforehand: no pipeline work during steps
  process       train()'s default, the pipeline in a worker process
  threaded      the pipeline on threads in the trainer's process, as the
                JAX package runs it (train(dataset=make_train_datasets(...)))
  threaded, 1   the same with torch.set_num_threads(1) (last: it is global)

    python3 tools/trainer_pipeline_ab.py [--steps 6]

Each line: the median of the trainer timer's total over steps 2..N (ms),
every step's total and dataset wait, and the card's name and power limit.
"""
import argparse
import copy
import os
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the fixture writer and the kernel sources)


class Recorder:
    def __init__(self):
        self.logs = {}

    def log(self, metrics, step):
        self.logs.setdefault(step, {}).update(metrics)


def main() -> int:
    import torch

    from hypervla_tpu_torch.data.pipeline import Pipeline
    from hypervla_tpu_torch.train import main as cli
    from hypervla_tpu_torch.train import trainer
    from hypervla_tpu_torch.utils import cuda_build

    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=6)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("trainer_pipeline_ab: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}; {os.cpu_count()} CPUs", flush=True)
    with ThreadPoolExecutor(len(chip_smoke.SOURCES)) as pool:
        list(pool.map(cuda_build.build, chip_smoke.SOURCES))

    root = tempfile.mkdtemp(prefix="hypervla_pipeline_ab_")
    data = os.path.join(root, "data")
    mix, _, encoding = chip_smoke.write_trainer_fixture(data)

    def config():
        c = cli.load_config(chip_smoke.TRAINER_CONFIG)
        cli.apply_overrides(c, [
            f"--config.dataset_kwargs.oxe_mix={mix!r}",
            f"--config.dataset_kwargs.data_dir={data!r}",
            f"--config.dataset_kwargs.batch_size={chip_smoke.TRAINER_BATCH}",
            "--config.dataset_kwargs.shuffle_buffer_size="
            f"{chip_smoke.TRAINER_SHUFFLE}",
            "--config.log_interval=1"])
        return c

    def run(name, dataset=None):
        rec = Recorder()
        trainer.train(config(), num_steps=args.steps, dataset=dataset,
                      wandb_run=rec, device="cuda")
        steps = range(2, args.steps + 1)
        total = [rec.logs[s]["timer/total"] * 1e3 for s in steps]
        wait = [rec.logs[s]["timer/dataset"] * 1e3 for s in steps]
        print(f"{name}: ms/step {statistics.median(total):.1f} (steps 2-"
              f"{args.steps}: {[round(t, 1) for t in total]}; dataset wait "
              f"{[round(t, 1) for t in wait]}); {encoding} frames; card "
              f"{card}", flush=True)

    made = trainer.make_train_datasets(config())
    it = iter(made)
    batches = [next(it) for _ in range(args.steps + 2)]
    materialized = Pipeline.from_iterable(
        lambda: iter(copy.deepcopy(batches)))
    materialized.dataset_statistics = made.dataset_statistics
    run("materialized", materialized)
    run("process")
    run("threaded", trainer.make_train_datasets(config()))
    torch.set_num_threads(1)
    run("threaded, torch threads 1", trainer.make_train_datasets(config()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
