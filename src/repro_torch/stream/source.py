"""Stream sources: deterministic row arrival with per-source rate budgets.

A ``StreamSource`` models one feed of rows entering a standing-query
watcher.  Two clocks matter:

- **arrival** — how many rows of the underlying record list have shown up
  by tick t.  Arrivals are a *deterministic function of the tick*
  (``arrivals(tick)``), never of wall time or call count, so a restarted
  watcher that replays ticks 1..k reconstructs exactly the rows — in
  exactly the order — the killed run ingested (docs/streaming.md).
- **ingestion** — how many arrived rows the watcher has actually drained
  into the table.  A ``RateBudget`` caps rows ingested per source per
  tick; rows past the cap stay in the source's backlog and are ingested
  on later ticks.  Quota exhaustion DEFERS rows, it never drops them —
  asserted in tests/test_torch_stream.py.

The per-source budget layers under the service's per-tenant admission
(``FilterService``): the budget shapes how many rows reach the table per
tick, the tenant budget then gates the oracle spend of evaluating them.

Concrete sources:
- ``SyntheticSource`` — wraps an in-memory record list (e.g. a
  ``make_dataset`` slice) with a seeded, possibly bursty arrival
  schedule.
- ``ReplayFileSource`` — replays a recorded JSONL stream
  (``{"text": ..., "embedding": [...]}`` per line) at a fixed arrival
  rate.

Arrivals are host numpy (``np.random.default_rng((seed, tick))``), so a
schedule is the same in every process and in both packages.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Callable, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class StreamRow:
    """One feed row.  ``embedding`` may be None only when the session has
    an embedder; sources used with checkpointing should carry embeddings
    so the restored table fingerprint never depends on the encoder."""
    text: Optional[str] = None
    embedding: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.text is None and self.embedding is None:
            raise ValueError("a StreamRow needs text and/or embedding")


@dataclasses.dataclass(frozen=True)
class RateBudget:
    """Per-source ingestion quota: at most ``rows_per_tick`` rows drained
    from this source each tick (None = unmetered)."""
    rows_per_tick: Optional[int] = None

    def cap(self, available: int) -> int:
        if self.rows_per_tick is None:
            return available
        return min(available, int(self.rows_per_tick))


class StreamSource:
    """Deterministic replayable source over a fixed record list.

    ``arrive_fn(tick) -> int`` gives the number of NEW records arriving
    at that tick; it must be a pure function of the tick.  The watcher
    drives the two-phase protocol: ``poll(tick)`` advances the arrival
    cursor, ``take(limit)`` drains up to ``limit`` rows from the backlog.
    """

    def __init__(self, name: str, records: Sequence[StreamRow],
                 arrive_fn: Callable[[int], int]):
        self.name = name
        self.records: List[StreamRow] = list(records)
        self.arrive_fn = arrive_fn
        self.arrived = 0     # records visible by the last polled tick
        self.ingested = 0    # records drained into the table
        self.last_tick = 0

    # ------------------------------------------------------------ protocol
    def poll(self, tick: int) -> int:
        """Advance arrivals to ``tick`` (idempotent per tick, monotonic);
        returns the backlog size.  Catches up skipped ticks so a watcher
        resuming at tick k+1 sees every arrival of ticks <= k+1."""
        while self.last_tick < tick:
            self.last_tick += 1
            self.arrived = min(len(self.records),
                               self.arrived + int(self.arrive_fn(
                                   self.last_tick)))
        return self.backlog

    def take(self, limit: Optional[int] = None) -> List[StreamRow]:
        """Drain up to ``limit`` arrived-but-uningested rows, in order."""
        hi = self.arrived if limit is None else min(
            self.arrived, self.ingested + max(0, int(limit)))
        rows = self.records[self.ingested:hi]
        self.ingested = hi
        return rows

    # ------------------------------------------------------------ state
    @property
    def backlog(self) -> int:
        return self.arrived - self.ingested

    @property
    def exhausted(self) -> bool:
        """Every record has both arrived and been ingested."""
        return self.ingested >= len(self.records)

    def state(self) -> dict:
        return {"arrived": int(self.arrived),
                "ingested": int(self.ingested),
                "last_tick": int(self.last_tick),
                "n_records": len(self.records)}

    def restore_state(self, st: dict) -> None:
        if st["n_records"] != len(self.records):
            raise ValueError(
                f"source {self.name!r}: checkpoint recorded "
                f"{st['n_records']} records, this source has "
                f"{len(self.records)} — not the same stream")
        self.arrived = int(st["arrived"])
        self.ingested = int(st["ingested"])
        self.last_tick = int(st["last_tick"])

    def __repr__(self):
        return (f"{type(self).__name__}({self.name!r}, "
                f"{self.ingested}/{len(self.records)} ingested, "
                f"backlog={self.backlog})")


class SyntheticSource(StreamSource):
    """In-memory records with a seeded arrival schedule.

    ``arrive_per_tick`` is either a fixed int or an ``(lo, hi)`` burst
    range sampled per tick from a tick-keyed RNG — deterministic across
    restarts by construction (the RNG is seeded with ``(seed, tick)``,
    never shared state)."""

    def __init__(self, name: str, texts: Optional[Sequence[str]] = None,
                 embeddings=None, arrive_per_tick=8, seed: int = 0):
        if embeddings is None and texts is None:
            raise ValueError("SyntheticSource needs texts and/or embeddings")
        n = len(texts) if texts is not None else len(embeddings)
        emb = (np.asarray(embeddings, np.float32)
               if embeddings is not None else None)
        records = [StreamRow(
            text=texts[i] if texts is not None else None,
            embedding=emb[i] if emb is not None else None)
            for i in range(n)]
        if isinstance(arrive_per_tick, (tuple, list)):
            lo, hi = int(arrive_per_tick[0]), int(arrive_per_tick[1])

            def arrive_fn(tick: int) -> int:
                rng = np.random.default_rng((int(seed), int(tick)))
                return int(rng.integers(lo, hi + 1))
        else:
            rate = int(arrive_per_tick)

            def arrive_fn(tick: int) -> int:
                return rate
        super().__init__(name, records, arrive_fn)


class ReplayFileSource(StreamSource):
    """Replay a recorded JSONL stream file at a fixed arrival rate.

    Each line is ``{"text": str?, "embedding": [float]?}``; at least one
    of the two must be present.  The whole file is materialized up front —
    replay determinism needs the full record list regardless, and recorded
    streams are checkpoint-sized, not unbounded."""

    def __init__(self, path, name: Optional[str] = None,
                 arrive_per_tick: int = 8):
        path = pathlib.Path(path)
        records = []
        with path.open() as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                emb = rec.get("embedding")
                records.append(StreamRow(
                    text=rec.get("text"),
                    embedding=(np.asarray(emb, np.float32)
                               if emb is not None else None)))
        rate = int(arrive_per_tick)
        super().__init__(name or path.stem, records, lambda tick: rate)
