"""mfu.replay: the least time the card could take for the traced
requests' model operations (perfbench/harness/counts.py::replay_request:
the reset and every frame, each precision at its peak), over the same
requests' measured time (untraced, host clock), in %."""
from perfbench.harness import counts


def read(ctx):
    if not ctx.timed_s:
        return None
    return 100.0 * counts.least_seconds(ctx.work["flops"]) / ctx.timed_s
