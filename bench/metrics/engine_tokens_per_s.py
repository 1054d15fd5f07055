"""Real prompt tokens (``engine_tick``'s ``tokens``) over the time of the
``engine_tick`` spans: the oracle's and serving engine's rate."""


def read(ctx):
    ticks = [s for s in ctx.spans if s.name == "engine_tick"]
    busy = sum(t.t1 - t.t0 for t in ticks)
    if not ticks or busy <= 0:
        return None
    return sum(t.attrs["tokens"] for t in ticks) / busy
