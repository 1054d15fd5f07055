"""The model FLOPs of the real prompt tokens the window's queries sent
(the architecture module's ``prefill_flops``: causal attention pairs,
MoE at top-k, a head of two logits) over the queries' wall time and the
card's dense bfloat16 peak, in %."""
from benchkit.devtrace import PEAK_BF16_FLOPS


def read(ctx):
    if not ctx.lens:
        return None
    seconds = ctx.win["t1"] - ctx.win["t0"]
    flops = ctx.arch.prefill_flops(ctx.d, ctx.lens)
    return 100.0 * flops / (seconds * PEAK_BF16_FLOPS)
