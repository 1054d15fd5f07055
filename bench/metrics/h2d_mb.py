"""Bytes a query that the CSV driver copies from the host to the card
(the ``bytes`` of its ``to_device`` spans: the rows and centroids of
every k-means, the rows, padded samples and labels of every vote), in
MB (1e6 bytes)."""


def read(ctx):
    sel = [s for s in ctx.spans if s.name == "to_device"]
    if not sel or not ctx.win["queries"]:
        return None
    return sum(s.attrs["bytes"] for s in sel) / 1e6 / len(ctx.win["queries"])
