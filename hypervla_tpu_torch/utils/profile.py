"""The trainer's profile window (counterpart of the XPlane read of
hypervla_tpu/train/trainer.py, utils/xplane.py::module_time_ms):
torch.profiler traces the window's steps into a chrome trace, and the
summary gives each device kernel's time per step. On the CPU, where no
device kernel runs, it gives each operator's own host time per step."""
import os
from typing import Dict, Tuple

import torch


def start_trace():
    """A running torch.profiler session over the host and, where there is
    one, the card."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof, profile_dir: str, rank: int = 0) -> str:
    """Stops the session and writes its chrome trace,
    <profile_dir>/trace_rank<rank>.json; returns the path."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"trace_rank{rank}.json")
    prof.export_chrome_trace(path)
    return path


def kernel_time_ms(prof) -> Tuple[str, Dict[str, Tuple[float, int]]]:
    """("device", {kernel: (ms, launches)}) of a stopped session, from its
    device records; where it holds none, ("host", {operator: (own host
    ms, calls)})."""
    from torch.autograd import DeviceType

    events = prof.key_averages()
    device = {e.key: (e.self_device_time_total / 1e3, e.count)
              for e in events
              if e.device_type == DeviceType.CUDA and e.count > 0}
    if device:
        return "device", device
    return "host", {e.key: (e.self_cpu_time_total / 1e3, e.count)
                    for e in events if e.count > 0}


def summary_lines(prof, steps: int):
    """The logged lines of a window of `steps` steps: each kernel's (or
    operator's) ms per step, longest first."""
    where, times = kernel_time_ms(prof)
    ranked = sorted(times.items(), key=lambda kv: -kv[1][0])
    return [f"profile: {name}: {ms / max(steps, 1):.4f} ms {where}/step "
            f"over {steps} steps ({count} launches)"
            for name, (ms, count) in ranked]
