"""The port's evaluation tools on the CPU:

  * tools/evaluate.py launches the children scripts/evaluate.py launches,
    argument for argument, with the port's modules in place of the JAX
    package's (subprocess.Popen recorded, nothing started);
  * tools/eval_pixel_env.py --fresh-tiny --cpu runs as a user runs it: the
    port's tiny checkpoint saved by the port, the policy server a child
    process, one episode of PixelReachEnv through a PolicyClient, and the
    JSON line printed, all under a deadline; and its episode loop,
    `run_episodes`, driven by an in-process stand-in."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from hypervla_tpu_torch.eval.pixel_env import PixelReachEnv
from scripts import evaluate as jevaluate
from test_torch_harness import torch_threads  # noqa: F401
from tools import eval_pixel_env
from tools import evaluate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds the pixel-env script may take, the server's start included
DEADLINE = 300


class _Recorder:
    def __init__(self):
        self.argvs = []

    def __call__(self, argv, *args, **kwargs):
        self.argvs.append(list(argv))
        return self

    def wait(self):
        return 0


@pytest.mark.parametrize("argv", [
    ["--folder", "runs/a", "--step_num", "7", "--seed_num", "2",
     "--save_video", "--window_size", "1", "--action_ensemble", "--crop",
     "--EMA", "0.999", "--recompute"],
    ["--policy_server", "gpu-host:8777", "--seed_num", "1",
     "--parallel_eval"],
    ["--benchmark", "libero_90", "--folder", "runs/b", "--split", "test",
     "--split_file", "split.pkl", "--seed_num", "2"],
    ["--benchmark", "libero_object", "--EMA", "0.99"],
])
def test_evaluate_launches_the_jax_scripts_children(monkeypatch, argv):
    launched = {}
    for name, module in (("jax", jevaluate), ("port", evaluate)):
        recorder = _Recorder()
        monkeypatch.setattr(module.subprocess, "Popen", recorder)
        module.main(list(argv))
        launched[name] = recorder.argvs
    swapped = [[a.replace("hypervla_tpu.eval.", "hypervla_tpu_torch.eval.")
                for a in cmd] for cmd in launched["jax"]]
    assert launched["port"] == swapped and swapped
    assert all(cmd[2].startswith("hypervla_tpu_torch.eval.")
               for cmd in launched["port"])


def test_pixel_env_script_runs_through_a_server_process(tmp_path):
    out = tmp_path / "result.json"
    # the fresh checkpoint goes to the temporary directory
    env = dict(os.environ, TMPDIR=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "eval_pixel_env.py"),
         "--fresh-tiny", "--cpu", "--episodes", "1", "--max-steps", "5",
         "--json-out", str(out)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=DEADLINE)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result == json.loads(out.read_text())
    assert result["episodes"] == 1 and result["steps"] == 5
    assert result["server_backend"] == "cpu"
    assert result["model_ms_p50"] > 0 and result["reset_s_p50"] >= 0
    assert result["checkpoint"].startswith(str(tmp_path))
    assert os.path.exists(os.path.join(result["checkpoint"], "0",
                                       "params.pt"))


class _Scripted:
    """A client that answers with the scripted expert's action."""

    def __init__(self, env):
        self.env = env
        self.resets = []

    def reset(self, task_description):
        self.resets.append(task_description)

    def step(self, frame):
        assert frame.shape == (64, 64, 3)
        from hypervla_tpu_torch.eval.pixel_env import scripted_expert

        return {"action": scripted_expert(self.env._agent, self.env._goal)}


def test_run_episodes_and_summary():
    env = PixelReachEnv(seed=0, max_steps=40)
    client = _Scripted(env)
    lines = []
    run = eval_pixel_env.run_episodes(client, env, 3, log=lines.append)
    assert run["successes"] == [True] * 3 and len(lines) == 3
    assert len(run["model_ms"]) == len(run["env_ms"]) == sum(run["steps"])
    assert client.resets == [env.get_task_description()] * 3
    summary = eval_pixel_env.summary(run)
    assert summary["success_rate"] == 1.0 and summary["episodes"] == 3
    assert summary["steps"] == sum(run["steps"])
    assert eval_pixel_env.server_command("ckpt", 5, image_size=224,
                                         cpu=True)[2:] == [
        "hypervla_tpu_torch.eval.policy_server", "--checkpoint", "ckpt",
        "--port", "5", "--policy_setup", "libero", "--image_size", "224",
        "--action_ensemble", "--cpu"]
    assert np.isfinite(summary["model_ms_p50"])
