"""The traced window's records, read from torch.profiler: every device
kernel (name, start, end), every host operator, and what a per-layer
metric reads from them. A trace that holds no device record is taken
again once; if the second holds none either, the run reports no traced
metric (never a 0)."""
from typing import Callable, Dict, List, Optional, Tuple

import torch


class Records:
    """The kernels and host operators of one traced window. Times in
    seconds on the profiler's clock."""

    def __init__(self, kernels: List[Tuple[str, float, float]],
                 host: List[Tuple[str, float, float]], window_s: float):
        self.kernels = sorted(kernels, key=lambda k: k[1])
        self.host = host
        self.window_s = window_s

    def busy_s(self) -> float:
        """Seconds in which some kernel ran (the union of their spans)."""
        busy, end = 0.0, float("-inf")
        for _, s, e in self.kernels:
            if e <= end:
                continue
            busy += e - max(s, end)
            end = e
        return busy

    def by_name(self, match: Callable[[str], bool]) -> Tuple[float, int]:
        """(device seconds, launches) of the kernels whose name matches."""
        total, n = 0.0, 0
        for name, s, e in self.kernels:
            if match(name):
                total += e - s
                n += 1
        return total, n

    def top_kernels(self, n: int = 10) -> List[list]:
        sums: Dict[str, float] = {}
        for name, s, e in self.kernels:
            sums[name] = sums.get(name, 0.0) + e - s
        return [[k[:120], v] for k, v in
                sorted(sums.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The device's idle time between kernels, summed by the host
        operator that was running at each gap's middle (the innermost
        one), the longest first."""
        import bisect

        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        sums: Dict[str, float] = {}
        end = None
        for _, s, e in self.kernels:
            if end is not None and s > end:
                mid = 0.5 * (s + end)
                label = "host: no operator"
                # the latest-starting operator that still runs at mid
                i = bisect.bisect_right(starts, mid) - 1
                for j in range(i, max(i - 5000, -1), -1):
                    if host[j][2] >= mid:
                        label = host[j][0]
                        break
                sums[label] = sums.get(label, 0.0) + s - end
            end = e if end is None else max(end, e)
        return [[k[:120], v] for k, v in
                sorted(sums.items(), key=lambda kv: -kv[1])[:n]]


def _collect(prof) -> Tuple[list, list]:
    kernels, host = [], []
    for ev in prof.events():
        start, end = ev.time_range.start * 1e-6, ev.time_range.end * 1e-6
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((ev.name, start, end))
        elif not ev.name.startswith("cuda") and ev.name != "":
            host.append((ev.name, start, end))
    return kernels, host


def traced(run: Callable[[], object], device) -> Optional[Records]:
    """Runs `run` under torch.profiler, twice if the first trace has no
    device record; None where neither has."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    for _ in range(2):
        with profile(activities=activities) as prof:
            t0 = _now(device)
            run()
            window = _now(device) - t0
        kernels, host = _collect(prof)
        if kernels:
            return Records(kernels, host, window)
    return None


def _now(device) -> float:
    import time

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter()
