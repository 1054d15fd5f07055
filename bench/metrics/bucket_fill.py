"""Real over padded tokens in the window's batches: the deltas of the
batcher's ``real_tokens`` and ``padded_tokens``."""


def read(ctx):
    if ctx.win["padded_tokens"] <= 0:
        return None
    return ctx.win["real_tokens"] / ctx.win["padded_tokens"]
