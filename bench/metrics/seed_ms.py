"""Host time a query of k-means seeding (the ``kmeans_seed`` spans: the
program's default k-means++ on the host, or an injected seeder), in ms."""
from benchkit.attribution import span_ms


def read(ctx):
    return span_ms(ctx, ("kmeans_seed",))
