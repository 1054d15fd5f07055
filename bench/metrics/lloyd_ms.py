"""Host time a query of k-means' Lloyd iterations and final assignment
(the ``kmeans_lloyd`` spans; K1 runs inside them and each iteration
waits for its stopping test), in ms."""
from benchkit.attribution import span_ms


def read(ctx):
    return span_ms(ctx, ("kmeans_lloyd",))
