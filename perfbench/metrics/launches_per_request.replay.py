"""launches_per_request.replay: the device operations (kernels, copies,
fills) the traced requests ran, per request."""


def read(ctx):
    if ctx.records is None:
        return None
    return len(ctx.records.kernels) / ctx.units
