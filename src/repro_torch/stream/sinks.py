"""Notification sinks: pluggable delivery with retry and a dead-letter log.

A ``Sink`` receives one event dict per newly-matching row
(``{"query", "tick", "row", "key", "text"}``).  The watcher never calls a
sink directly — every sink is wrapped in a ``SinkRunner`` that

- retries a failing ``emit`` up to ``retries`` times (synchronously,
  within the tick — a stream tick is the natural retry horizon);
- **dead-letters** an event whose retries are exhausted: the event plus
  the final error is appended to an in-memory log and, when the runner
  has a ``dead_letter_path``, to a JSONL file.  A dead-lettered row is
  still acknowledged by the delta engine — notification is at-most-once
  per (query, content); the dead-letter log is the recovery record, not
  a retry queue (docs/streaming.md#delta--dedup-semantics);
- counts everything in ``SinkStats`` (``sink.delivered``,
  ``sink.deduped``, ``sink.dead_lettered``, ``sink.retries`` under the
  unified metric scheme) and mirrors the increments into the active
  tracer's metrics registry.

Concrete sinks: ``StdoutSink`` (one JSON line per event to stdout),
``JsonlSink`` (append to a file), ``CallbackSink`` (hand the event to a
function — the test/integration hook).
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import sys
from typing import Callable, List, Optional

from repro_torch.obs.trace import get_tracer


@dataclasses.dataclass
class SinkStats:
    """Delivery accounting for one standing query's sink."""
    n_delivered: int = 0
    n_deduped: int = 0        # suppressed by the delta engine's seen-set
    n_dead_lettered: int = 0
    n_retries: int = 0

    def metrics_view(self) -> dict:
        return {
            "sink.delivered": self.n_delivered,
            "sink.deduped": self.n_deduped,
            "sink.dead_lettered": self.n_dead_lettered,
            "sink.retries": self.n_retries,
        }


class Sink:
    """Delivery target interface.  ``emit`` may raise (the runner
    retries); ``flush`` must make everything emitted so far durable —
    graceful shutdown calls it before the final checkpoint."""

    def emit(self, event: dict) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self.flush()


class StdoutSink(Sink):
    def __init__(self, prefix: str = "match"):
        self.prefix = prefix

    def emit(self, event: dict) -> None:
        print(f"[{self.prefix}] {json.dumps(event, sort_keys=True)}")

    def flush(self) -> None:
        sys.stdout.flush()


class JsonlSink(Sink):
    """Append one JSON line per event; the file handle stays open across
    ticks and is flushed on ``flush()``/``close()``."""

    def __init__(self, path):
        self.path = pathlib.Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = None

    def emit(self, event: dict) -> None:
        if self._fh is None:
            self._fh = self.path.open("a")
        self._fh.write(json.dumps(event, sort_keys=True) + "\n")

    def flush(self) -> None:
        if self._fh is not None:
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class CallbackSink(Sink):
    def __init__(self, fn: Callable[[dict], None],
                 flush_fn: Optional[Callable[[], None]] = None):
        self.fn = fn
        self.flush_fn = flush_fn

    def emit(self, event: dict) -> None:
        self.fn(event)

    def flush(self) -> None:
        if self.flush_fn is not None:
            self.flush_fn()


class SinkRunner:
    """Retry + dead-letter wrapper around one sink (see module doc)."""

    def __init__(self, sink: Sink, retries: int = 2,
                 dead_letter_path=None):
        self.sink = sink
        self.retries = max(0, int(retries))
        self.stats = SinkStats()
        self.dead_letters: List[dict] = []
        self.dead_letter_path = (pathlib.Path(dead_letter_path)
                                 if dead_letter_path is not None else None)

    def deliver(self, event: dict) -> bool:
        """Emit with retries; dead-letter on exhaustion.  Returns whether
        the event was delivered."""
        tr = get_tracer()
        err: Optional[BaseException] = None
        for attempt in range(self.retries + 1):
            try:
                self.sink.emit(event)
            except Exception as e:
                err = e
                if attempt < self.retries:
                    self.stats.n_retries += 1
                    tr.metrics.inc("sink.retries")
            else:
                self.stats.n_delivered += 1
                tr.metrics.inc("sink.delivered")
                return True
        self.stats.n_dead_lettered += 1
        tr.metrics.inc("sink.dead_lettered")
        rec = dict(event)
        rec["error"] = f"{type(err).__name__}: {err}"
        self.dead_letters.append(rec)
        if self.dead_letter_path is not None:
            self.dead_letter_path.parent.mkdir(parents=True, exist_ok=True)
            with self.dead_letter_path.open("a") as f:
                f.write(json.dumps(rec, sort_keys=True) + "\n")
        return False

    def note_deduped(self, n: int) -> None:
        """Record rows the delta engine suppressed as duplicates."""
        if n:
            self.stats.n_deduped += int(n)
            get_tracer().metrics.inc("sink.deduped", int(n))

    def flush(self) -> None:
        self.sink.flush()

    def close(self) -> None:
        self.sink.close()
