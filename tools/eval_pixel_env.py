#!/usr/bin/env python3
"""Closed loop across a process boundary: the pixel environment driven
through the port's policy server.

env process <-> TCP <-> policy-server process running reset (hypernetwork
generation) -> N x (render -> sample_actions -> ensemble -> postprocess),
with the per-episode model-vs-environment wall times a simulator evaluation
prints. PixelReachEnv (hypervla_tpu_torch/eval/pixel_env.py) stands in for
the simulator. The flags are those of the JAX package's
scripts/eval_pixel_env.py; the server is `python -m
hypervla_tpu_torch.eval.policy_server`, on the CUDA card unless --cpu.

Usage:
  # a fresh tiny checkpoint (the port's, saved by the port), CPU server
  python tools/eval_pixel_env.py --fresh-tiny --cpu --episodes 5

  # an existing checkpoint of the port, served on the card
  python tools/eval_pixel_env.py --checkpoint <dir> --episodes 10

The server takes 64-px frames here (--image_size 64, as the JAX script
starts it): a DINOv2 model needs 224, so serve one with `run_episodes`
against a server started with --image_size 224.
"""
import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402


def make_fresh_tiny_checkpoint(ckpt_dir: str) -> str:
    """Saves an untrained tiny HyperVLA checkpoint of the port (the JAX
    script's tiny SmallStem model: config.json, example_batch.npz,
    dataset_statistics.json and the step-0 params) on the CPU, so that the
    server has something to load without a training run."""
    from hypervla_tpu_torch.configs import tiny_test_config
    from hypervla_tpu_torch.flagship import make_flagship_batch
    from hypervla_tpu_torch.models.hypervla import HyperVLA

    config = tiny_test_config(encoder_type="SmallStem")
    batch = make_flagship_batch(batch_size=2, instr_len=8, image_size=64,
                                action_horizon=2, initial_patch_dim=32)
    model = HyperVLA.from_config(
        config, batch, seed=0,
        dataset_statistics={"action": {"mean": np.zeros(7),
                                       "std": np.ones(7)}},
        device="cpu")
    model.save_pretrained(step=0, checkpoint_path=ckpt_dir)
    return ckpt_dir


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def server_command(checkpoint: str, port: int, image_size: int = 64,
                   cpu: bool = False) -> list:
    """The argv of the policy server this script starts."""
    cmd = [sys.executable, "-m", "hypervla_tpu_torch.eval.policy_server",
           "--checkpoint", checkpoint, "--port", str(port),
           "--policy_setup", "libero", "--image_size", str(image_size),
           "--action_ensemble"]
    return cmd + (["--cpu"] if cpu else [])


def start_server(cmd: list) -> subprocess.Popen:
    """Starts the server with this repository on its PYTHONPATH."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (env.get("PYTHONPATH"), REPO) if p)
    return subprocess.Popen(cmd, env=env)


def wait_for_server(client_cls, host, port, proc, timeout_s=420):
    """A client of the server once it answers a ping; raises if the
    server exits first or has not answered after timeout_s."""
    t0 = time.time()
    while time.time() - t0 < timeout_s:
        if proc.poll() is not None:
            raise RuntimeError(
                f"policy server exited early with {proc.returncode}")
        try:
            client = client_cls(host, port)
            if client.ping().get("ok"):
                return client
        except (ConnectionRefusedError, OSError):
            time.sleep(1.0)
    raise TimeoutError("policy server did not come up")


def run_episodes(client, env, episodes: int, log=print) -> dict:
    """Drives `episodes` episodes of env (seeds 0, 1, ...) through client:
    anything with reset(task_description) and step(frame) -> {"action":
    ...} (a PolicyClient, or an in-process stand-in). Returns the
    per-episode successes and steps and the wall times of every reset
    (hypernetwork generation), model step and env step."""
    successes, steps, model_ms, env_ms, reset_s = [], [], [], [], []
    for ep in range(episodes):
        obs, _ = env.reset(seed=ep)
        t0 = time.perf_counter()
        client.reset(env.get_task_description())
        reset_s.append(time.perf_counter() - t0)
        success, n = False, 0
        while True:
            t0 = time.perf_counter()
            reply = client.step(obs)
            model_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            obs, _, terminated, truncated, step_info = env.step(
                reply["action"])
            env_ms.append((time.perf_counter() - t0) * 1e3)
            n += 1
            if terminated or truncated:
                success = bool(step_info["success"])
                break
        successes.append(success)
        steps.append(n)
        log(f"episode {ep}: success={success} steps={n} "
            f"reset(hypernet)={reset_s[-1]:.2f}s "
            f"model={np.mean(model_ms):.1f}ms/step "
            f"env={np.mean(env_ms):.2f}ms/step")
    return {"successes": successes, "steps": steps, "model_ms": model_ms,
            "env_ms": env_ms, "reset_s": reset_s}


def summary(run: dict) -> dict:
    """The JSON fields the JAX script prints, from run_episodes' result."""
    model_ms = run["model_ms"]
    return {
        "metric": "pixel-env closed loop through policy server",
        "success_rate": float(np.mean(run["successes"])),
        "episodes": len(run["successes"]),
        "steps": len(model_ms),
        "actions_per_sec_through_server": round(
            1e3 / float(np.median(model_ms)), 1),
        "model_ms_p50": round(float(np.median(model_ms)), 2),
        "env_ms_p50": round(float(np.median(run["env_ms"])), 3),
        "reset_s_p50": round(float(np.median(run["reset_s"])), 2),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--fresh-tiny", action="store_true",
                    help="save an untrained tiny checkpoint and use it")
    ap.add_argument("--episodes", type=int, default=5)
    ap.add_argument("--max-steps", type=int, default=40)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run the server on the CPU")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)

    from hypervla_tpu_torch.eval.pixel_env import PixelReachEnv
    from hypervla_tpu_torch.eval.policy_server import PolicyClient

    if args.fresh_tiny:
        ckpt = make_fresh_tiny_checkpoint(
            tempfile.mkdtemp(prefix="pixel_env_ckpt_"))
    else:
        if not args.checkpoint:
            raise SystemExit("--checkpoint or --fresh-tiny required")
        ckpt = args.checkpoint

    port = args.port or free_port()
    proc = start_server(server_command(ckpt, port, cpu=args.cpu))
    try:
        client = wait_for_server(PolicyClient, "127.0.0.1", port, proc)
        env = PixelReachEnv(seed=0, max_steps=args.max_steps)
        run = run_episodes(client, env, args.episodes,
                           log=lambda msg: print(msg, flush=True))
        client.close()
    finally:
        proc.terminate()
        proc.wait(timeout=30)

    result = dict(summary(run), checkpoint=ckpt,
                  server_backend="cpu" if args.cpu else "cuda")
    print(json.dumps(result), flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(result, f)
    return result


if __name__ == "__main__":
    main()
