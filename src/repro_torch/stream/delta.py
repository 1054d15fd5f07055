"""Delta engine: newly-matching rows between ticks, with content dedup.

Each ``StandingQuery`` owns one ``DeltaTracker``.  After a tick's
evaluation produces the query's full-table mask, the tracker diffs it
against the *last acknowledged* mask and yields exactly the rows that
newly match:

- rows appended since the last ack default to "did not match" (the acked
  mask is padded with False), so a new row that matches notifies once;
- a row that flips True -> False is NOT notified (standing queries push
  matches, not retractions — the acked mask still records the flip, so a
  later flip back to True would re-emit *positionally*);
- **content-hash dedup** sits on top of the positional diff: every
  notified row's content key (``row_key``: text bytes if present, else
  embedding bytes) enters a per-query seen-set, and any later row with
  the same key — a replayed feed chunk, a duplicate submission, or a
  True->False->True flip of identical content — is counted as deduped
  instead of re-notified.  This is what makes notification exactly-once
  per (query, content) across duplicates AND across kill/restart: the
  seen-set and acked mask are checkpointed with the watcher
  (docs/streaming.md#restart-guarantees).

``delta()`` computes, ``ack()`` commits — the watcher acks only after
the tick's sink deliveries are resolved (delivered or dead-lettered), so
a crash between the two re-derives the same notification set on restart
rather than silently skipping it.

Keys hash the numpy float32 bytes of a row (never a tensor's), so keys,
dedup and checkpointed seen-sets are the same as the ``repro`` package's.
"""
from __future__ import annotations

import hashlib
from typing import List, Optional, Tuple

import numpy as np


def row_key(text: Optional[str], embedding=None) -> str:
    """Content hash of one row: text bytes when present, else embedding
    bytes.  This is the dedup identity — two feed rows with equal content
    notify at most once per standing query."""
    h = hashlib.blake2b(digest_size=16)
    if text is not None:
        h.update(b"t:")
        h.update(text.encode("utf-8"))
    else:
        emb = np.ascontiguousarray(embedding, dtype=np.float32)
        h.update(b"e:")
        h.update(emb.tobytes())
    return h.hexdigest()


class DeltaTracker:
    """Acked-mask diff + content seen-set for one standing query."""

    def __init__(self):
        self.acked = np.zeros(0, dtype=bool)
        self.seen: set = set()

    def delta(self, mask: np.ndarray,
              row_keys: List[str]) -> Tuple[List[int], int]:
        """Rows of ``mask`` that newly match since the last ack.

        Returns ``(emit_rows, n_deduped)``: row ids to notify (their keys
        are committed to the seen-set immediately — a tick that emits a
        row and dead-letters it must not re-emit on the next tick) and
        the count suppressed by content dedup."""
        mask = np.asarray(mask, dtype=bool)
        if len(mask) < len(self.acked):
            raise ValueError(
                f"mask shrank ({len(mask)} < {len(self.acked)} acked rows);"
                " standing queries are append-only")
        base = np.zeros(len(mask), dtype=bool)
        base[:len(self.acked)] = self.acked
        emit, deduped = [], 0
        for i in np.nonzero(mask & ~base)[0]:
            key = row_keys[i]
            if key in self.seen:
                deduped += 1
            else:
                self.seen.add(key)
                emit.append(int(i))
        return emit, deduped

    def ack(self, mask: np.ndarray) -> None:
        """Commit ``mask`` as the delivered baseline for the next tick."""
        self.acked = np.asarray(mask, dtype=bool).copy()

    # -------------------------------------------------------- checkpoint
    def state(self) -> dict:
        return {"seen": sorted(self.seen)}

    def restore_state(self, st: dict, acked: np.ndarray) -> None:
        self.seen = set(st["seen"])
        self.acked = np.asarray(acked, dtype=bool).copy()
