"""Standing semantic queries over live streams (docs/streaming.md).

Continuous ingestion (``StreamSource`` + ``RateBudget``), incremental
evaluation of registered predicates via dirty-cluster re-votes
(``StandingQuery`` inside a ``StreamWatcher``), newly-matching-row deltas
with content dedup (``DeltaTracker``), and pluggable notification sinks
with retry + dead-letter (``SinkRunner``).  Checkpoint/restore rides on
``repro_torch.service.store.SessionStore``.

The stream layer is host code: arrivals, deltas, dedup and sinks are
numpy and the standard library.  What runs on the card is what a tick
asks of its session: the nearest-centroid patch of the new rows (K1), the
re-votes of the dirty clusters (K3 under SimVote) and, for ``ModelOracle``
predicates, the engine's prefill (K4).
"""
from repro_torch.stream.delta import DeltaTracker, row_key
from repro_torch.stream.sinks import (CallbackSink, JsonlSink, Sink,
                                      SinkRunner, SinkStats, StdoutSink)
from repro_torch.stream.source import (RateBudget, ReplayFileSource,
                                       StreamRow, StreamSource,
                                       SyntheticSource)
from repro_torch.stream.watcher import (StandingQuery, StreamStats,
                                        StreamWatcher)

__all__ = [
    "DeltaTracker", "row_key",
    "CallbackSink", "JsonlSink", "Sink", "SinkRunner", "SinkStats",
    "StdoutSink",
    "RateBudget", "ReplayFileSource", "StreamRow", "StreamSource",
    "SyntheticSource",
    "StandingQuery", "StreamStats", "StreamWatcher",
]
