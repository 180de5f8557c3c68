#!/usr/bin/env python3
"""The port's train step on several cards, under torchrun, against the
same steps in one process:

    torchrun --nproc_per_node 4 tools/multi_card_train.py [--cpu]

The fast-preset flagship at full width from a seed and its fixed batch of
64 (chip_smoke.py::_multi_device_setup); rank 0 first takes MULTI_STEPS
steps alone at batch 64. Then, for each layout (fsdp, tp) the world
divides, (1, 1), (2, 1) and (2, 2) at 4 ranks: the mesh over every rank
(parallel/mesh.py), the state sharded (parallel/sharded.py), the same
steps on each rank's rows. Checks, on every layout: each step's
training_loss and grad_norm within rtol 2e-4, atol 1e-5 of the one
process's (the JAX package's bound between meshes), every rank's
gathered params bit-equal after the steps, each rank launching kernels 2
and 3 (12 + 12 and 12 a step, as one process does), and with tp > 1 the
fan-out kernel held and multiplied split, never whole
(parallel/dryrun.py::check_fanout_partitioned). Prints, on rank 0, each
layout's per-step numbers and host ms a step (a card a rank), one JSON
line, and the card's name and power limit; exits non-zero on a failed
check. --cpu runs gloo ranks on the CPU (a rehearsal at the full width is
too large for a CPU; patch the setup to a small model first).

--trainer instead runs the training command line under torchrun: rank 0
writes chip_smoke.py's fixture datasets and a config file of
`vit_t,oxe,fast` over them (batch 64), and trains TRAINER_CHECK_STEPS
steps in one process, without a group, before it joins; then every rank
runs `main([... --fsdp 2 --tp 2])` (each rank its own pipeline, keeping
its rows), and rank 0 holds each step's training_loss to the one
process's (rtol 2e-4, atol 1e-5) and checks that rank 0 wrote the
checkpoint.
"""
import argparse
import datetime
import json
import math
import os
import subprocess
import sys
import time

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from hypervla_tpu_torch.ops import dino_layer_train as dlt  # noqa: E402
from hypervla_tpu_torch.ops import fused_attention as fa  # noqa: E402
from hypervla_tpu_torch.parallel.dryrun import (  # noqa: E402
    check_fanout_partitioned,
)
from hypervla_tpu_torch.parallel.mesh import (  # noqa: E402
    create_mesh,
    process_count,
    process_index,
    shard_batch,
)
from hypervla_tpu_torch.train.train_step import make_train_step  # noqa
from hypervla_tpu_torch.utils.device import resolve_device  # noqa: E402

LAYOUTS = ((1, 1), (2, 1), (2, 2))
#: the trainer's steps, each rank on its rows of the global batch
TRAINER_CHECK_STEPS = 3


def card_name() -> str:
    if not torch.cuda.is_available():
        return "no card"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def run_steps(step_fn, state, batch, encoders, steps, device):
    """(infos, host ms a step, kernels 2 and 3's launches) of `steps`
    steps from `state`; the final state."""
    for module in (fa, dlt):
        module.reset_launch_counts()
    infos, ms = [], []
    for _ in range(steps):
        chip_smoke._sync(device)
        t0 = time.perf_counter()
        state, info = step_fn(state, batch, None, encoders,
                              with_metrics=True)
        infos.append({k: float(v) for k, v in info.items()})
        chip_smoke._sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k: v for k, v in {**fa.LAUNCHES, **dlt.LAUNCHES}.items()
                if k in chip_smoke.FAST_PRESET_LAUNCHES}
    return infos, ms, launches, state


def init_group(cpu: bool) -> None:
    # a collective that waits fails the run after 5 minutes, not 10
    dist.init_process_group("gloo" if cpu else "nccl", init_method="env://",
                            timeout=datetime.timedelta(minutes=5))


def trainer_check(cpu: bool) -> int:
    """The --trainer mode (module docstring)."""
    from hypervla_tpu_torch.train import main as cli
    from hypervla_tpu_torch.train import trainer

    root = os.path.join(ROOT, "build", "multi_card_trainer")
    run_dir = os.path.join(root, "run")
    path = os.path.join(root, "config.py")
    device = torch.device("cpu") if cpu else torch.device(
        "cuda", int(os.environ.get("LOCAL_RANK", "0")))
    rank = int(os.environ["RANK"])
    if rank == 0:
        import shutil

        shutil.rmtree(root, ignore_errors=True)
        data = os.path.join(root, "data")
        _, names, _ = chip_smoke.write_trainer_fixture(data)
        config = cli.load_config(chip_smoke.TRAINER_CONFIG)
        config["dataset_kwargs"].update(
            oxe_mix=None, batch_size=chip_smoke.TRAINER_BATCH,
            shuffle_buffer_size=chip_smoke.TRAINER_SHUFFLE,
            resize_size={"primary": (224, 224)},
            dataset_kwargs_list=[dict(
                name=name, data_dir=data,
                image_obs_keys={"primary": "image"},
                language_key="language_instruction",
                action_proprio_normalization_type="normal",
                add_initial_image=True) for name in names])
        config.update(num_steps=TRAINER_CHECK_STEPS, log_interval=1,
                      save_interval=TRAINER_CHECK_STEPS)
        with open(path, "w") as f:
            f.write(f"def get_config(s):\n    return {config!r}\n")
        alone = chip_smoke.LogRecorder()
        t0 = time.perf_counter()
        # one process: train() must not join torchrun's group here
        world_size = os.environ.pop("WORLD_SIZE")
        try:
            trainer.train(cli.load_config(f"{path}:x"), wandb_run=alone,
                          device=device)
        finally:
            os.environ["WORLD_SIZE"] = world_size
        alone_s = time.perf_counter() - t0
    init_group(cpu)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    # the others wait here for rank 0's fixture, config and one-process run
    # (an nccl group, unlike gloo's, forms without waiting for every rank)
    dist.barrier()
    ranks = chip_smoke.LogRecorder()
    cli._wandb_run = lambda args, config: ranks
    t0 = time.perf_counter()
    state = cli.main(["--config", f"{path}:x", "--save_dir", run_dir,
                      "--fsdp", "2", "--tp", "2",
                      *(["--cpu"] if cpu else [])])
    group_s = time.perf_counter() - t0
    world = process_count()
    dist.destroy_process_group()
    if rank != 0:
        return 0
    card = card_name()
    errors = []
    steps = range(1, TRAINER_CHECK_STEPS + 1)
    got = [ranks.logs[s]["training_loss"] for s in steps]
    want = [alone.logs[s]["training_loss"] for s in steps]
    for step, (g, w) in enumerate(zip(got, want), 1):
        if not math.isclose(g, w, rel_tol=chip_smoke.MESH_RTOL,
                            abs_tol=chip_smoke.MESH_ATOL):
            errors.append(f"trainer step {step}: {world} ranks {g!r}, one "
                          f"process {w!r}")
    saved = os.path.join(run_dir, str(TRAINER_CHECK_STEPS), "params.pt")
    if state.step != TRAINER_CHECK_STEPS or not os.path.exists(saved):
        errors.append(f"step {state.step}, checkpoint {saved} written: "
                      f"{os.path.exists(saved)}")
    print(f"trainer on {world} ranks (fsdp 2, tp 2), batch "
          f"{chip_smoke.TRAINER_BATCH}: losses {got}, one process {want}; "
          f"{group_s:.2f} s and {alone_s:.2f} s with start-up; card {card}",
          flush=True)
    print(json.dumps({"world": world, "card": card, "trainer_losses": got,
                      "one_process_losses": want, "errors": errors}),
          flush=True)
    return 1 if errors else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cpu", action="store_true",
                        help="gloo ranks on the CPU")
    parser.add_argument("--steps", type=int, default=chip_smoke.MULTI_STEPS)
    parser.add_argument("--trainer", action="store_true",
                        help="the training command line under torchrun")
    args = parser.parse_args(argv)
    if int(os.environ.get("WORLD_SIZE", "1")) < 2:
        raise SystemExit("run under torchrun with more than one process")
    if args.trainer:
        return trainer_check(args.cpu)
    init_group(args.cpu)
    rank, world = process_index(), process_count()
    device = torch.device("cpu") if args.cpu else resolve_device(None)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    model, config, step_args, (text_apply, dino_apply), encoders, state0, \
        batch = chip_smoke._multi_device_setup(device)
    build_s = time.perf_counter() - t0
    tx = step_args[0]
    ref = None
    if rank == 0:
        step_fn = make_train_step(model, config, *step_args,
                                  text_encode=text_apply,
                                  dino_encode=dino_apply)
        ref = run_steps(step_fn, state0, batch, encoders, args.steps,
                        device)[:3]
        del step_fn
    dist.barrier()
    report = []
    for fsdp, tp in LAYOUTS:
        if world % (fsdp * tp):
            continue
        failures = []
        mesh = create_mesh(fsdp=fsdp, tp=tp)
        step_fn = make_train_step(model, config, *step_args,
                                  text_encode=text_apply,
                                  dino_encode=dino_apply, mesh=mesh)
        layout = step_fn.layout
        state = layout.shard_state(state0, tx)
        held = {n: tuple(state.params[n].shape) for n in layout.tp}
        infos, ms, launches, state = run_steps(
            step_fn, state, shard_batch(batch, mesh), encoders, args.steps,
            device)
        whole = layout.gather_tree(state.params)
        same = chip_smoke._same_on_ranks(whole)
        fanout = None
        if tp > 1:
            try:
                fanout = check_fanout_partitioned(
                    layout.fanout_records, held, mesh.shape, whole)
            except AssertionError as e:
                failures.append(f"rank {rank} {mesh.shape}: {e}")
        per_rank = [None] * world
        dist.all_gather_object(per_rank, {"infos": infos, "ms": ms,
                                          "launches": launches,
                                          "failures": failures})
        report.append({"mesh": dict(mesh.shape), "same": same,
                       "fanout": fanout, "ranks": per_rank})
        del step_fn, state, whole
        if device.type == "cuda":
            torch.cuda.empty_cache()
    dist.barrier()
    dist.destroy_process_group()
    if rank != 0:
        return 0

    card = card_name()
    ref_infos, ref_ms, ref_launches = ref
    want = {k: v * args.steps
            for k, v in chip_smoke.FAST_PRESET_LAUNCHES.items()}
    errors = [f for entry in report for r in entry["ranks"]
              for f in r["failures"]]
    if ref_launches != want:
        errors.append(f"one process launched {ref_launches}, want {want}")
    print(f"one process, batch {chip_smoke.TRAIN_BATCH}: losses "
          f"{[i['training_loss'] for i in ref_infos]}, grad_norms "
          f"{[i['grad_norm'] for i in ref_infos]}, ms "
          f"{[round(x, 2) for x in ref_ms]} (host clock); build "
          f"{build_s:.2f} s; card {card}", flush=True)
    out = []
    for entry in report:
        worst = 0.0
        for r, got in enumerate(entry["ranks"]):
            if got["launches"] != want:
                errors.append(f"{entry['mesh']} rank {r} launched "
                              f"{got['launches']}, want {want}")
            for step, (g, w) in enumerate(zip(got["infos"], ref_infos), 1):
                for key in ("training_loss", "grad_norm"):
                    worst = max(worst, abs(g[key] - w[key])
                                / max(abs(w[key]), 1e-30))
                    if not math.isclose(g[key], w[key],
                                        rel_tol=chip_smoke.MESH_RTOL,
                                        abs_tol=chip_smoke.MESH_ATOL):
                        errors.append(f"{entry['mesh']} rank {r} step "
                                      f"{step} {key}: {g[key]!r}, one "
                                      f"process {w[key]!r}")
        if not entry["same"]:
            errors.append(f"{entry['mesh']}: the ranks' params differ")
        rank0 = entry["ranks"][0]
        print(f"mesh {entry['mesh']}: losses "
              f"{[i['training_loss'] for i in rank0['infos']]}, grad_norms "
              f"{[i['grad_norm'] for i in rank0['infos']]}, worst relative "
              f"difference from one process {worst:.3g}, params bit-equal "
              f"on every rank: {entry['same']}, launches a rank "
              f"{rank0['launches']}, ms a step (host clock, a card a rank) "
              + str([[round(x, 2) for x in r['ms']]
                     for r in entry["ranks"]])
              + (f", fan-out {entry['fanout']}" if entry["fanout"] else "")
              + f"; card {card}", flush=True)
        out.append({"mesh": entry["mesh"], "worst_rel": worst,
                    "same": entry["same"],
                    "ms": [r["ms"] for r in entry["ranks"]]})
    print(json.dumps({"world": world, "card": card, "one_process_ms": ref_ms,
                      "layouts": out, "errors": errors}), flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
