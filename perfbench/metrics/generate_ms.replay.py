"""generate_ms.replay: the benchmark's own span around each traced
request's `create_tasks` (the hypernetwork's forward), by CUDA events,
averaged over the requests, in ms."""


def read(ctx):
    spans = ctx.work.get("generate_ms") or []
    if not spans:
        return None
    return sum(spans) / len(spans)
