"""Device time a query of the kernels launched inside ``attn`` spans,
the model's attention layers (projections, RoPE, K4 and the output
projection), each kernel joined to its launch by
``benchkit.attribution``, in ms."""
from benchkit.attribution import kind_ms


def read(ctx):
    return kind_ms(ctx, "attn")
