"""Host time a query of the CSV driver packing table rows for the card:
the ``gather_rows`` spans (numpy gathers of the rows a vote or a
re-clustering needs) and the ``vote_pack`` spans (the unsampled rows
concatenated, the padded samples, labels and bandwidths), in ms."""
from benchkit.attribution import span_ms


def read(ctx):
    return span_ms(ctx, ("gather_rows", "vote_pack"))
