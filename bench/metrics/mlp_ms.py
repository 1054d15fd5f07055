"""Device time a query of the kernels launched inside ``mlp`` spans, the
model's dense FFN layers, each kernel joined to its launch by
``benchkit.attribution``, in ms."""
from benchkit.attribution import kind_ms


def read(ctx):
    return kind_ms(ctx, "mlp")
