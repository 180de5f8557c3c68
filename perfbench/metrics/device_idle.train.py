"""device_idle.train: the share of the traced steps' untraced wall time
(the same steps timed just before the trace, so that the profiler's own
overhead is not counted as idle) in which no operation ran on the card,
in %."""


def read(ctx):
    if ctx.records is None or not ctx.timed_s:
        return None
    return 100.0 * (1.0 - ctx.records.busy_s() / ctx.timed_s)
