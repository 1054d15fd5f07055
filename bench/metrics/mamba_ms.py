"""Device time a query of the kernels launched inside ``mamba`` spans,
the model's Mamba layers (projections, the convolution and the
selective scan), each kernel joined to its launch by
``benchkit.attribution``, in ms."""
from benchkit.attribution import kind_ms


def read(ctx):
    return kind_ms(ctx, "mamba")
