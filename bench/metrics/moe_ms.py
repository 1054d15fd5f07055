"""Device time a query of the kernels launched inside ``moe`` spans, the
model's MoE FFN layers (the router, the dispatch and the experts'
products), each kernel joined to its launch by ``benchkit.attribution``,
in ms."""
from benchkit.attribution import kind_ms


def read(ctx):
    return kind_ms(ctx, "moe")
