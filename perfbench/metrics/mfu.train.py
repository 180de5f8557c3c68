"""mfu.train: the least time the card could take for a training step's
operations (perfbench/harness/counts.py::train_step, each precision at its
peak), over the step's measured time (untraced steps, host clock), in %."""
from perfbench.harness import counts


def read(ctx):
    if not ctx.units or not ctx.timed_s:
        return None
    least = counts.least_seconds(ctx.work["step_flops"])
    return 100.0 * least * ctx.units / ctx.timed_s
