"""Device time of K1 (k-means assignment) and K2/K3 (SimVote) a query,
by kernel name, in ms."""

KERNELS = r"assign_kernel|simvote_kernel"


def read(ctx):
    if ctx.trace is None or not ctx.win["queries"]:
        return None
    s = ctx.trace.kernel_seconds(KERNELS)
    if s <= 0:
        return None
    return 1000.0 * s / len(ctx.win["queries"])
