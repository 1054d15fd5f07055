"""Content-hash keyed embedding cache: the session-scoped reuse layer.

The paper's phase 1 (offline embedding) is query-agnostic, so in a session
that filters the same or overlapping data repeatedly the embeddings are the
first thing worth amortizing.  ``EmbeddingCache`` maps a hash of each text's
*content* (not its position) to its embedding row, so:

- registering a second table whose rows overlap an earlier one embeds only
  the genuinely new rows;
- ``TableHandle.append``/``update`` embed only the appended/changed rows;
- duplicate texts inside one batch are embedded once.

A ``Session`` owns one cache by default (two sessions never share state);
pass the same ``EmbeddingCache`` instance to several sessions to share
embeddings explicitly (``Session(embedding_cache=shared)``).
"""
from __future__ import annotations

import hashlib
from typing import Callable, Sequence

import numpy as np


def content_key(text: str) -> str:
    """Stable content hash of one tuple's text payload."""
    return hashlib.blake2b(text.encode("utf-8"), digest_size=16).hexdigest()


class EmbeddingCache:
    """Text-content -> embedding row store with hit/miss accounting.

    ``encoded_rows`` counts rows actually sent to the underlying embedder —
    the number the session-reuse benchmark and tests assert on.
    """

    def __init__(self):
        self._store: dict[str, np.ndarray] = {}
        self.hits = 0
        self.misses = 0
        self.encoded_rows = 0
        # durability hook: called as hook(keys, rows) after fresh rows are
        # inserted (repro_torch.service.log appends them so a restart
        # rebuilds the cache without re-encoding)
        self.hook = None

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, text: str) -> bool:
        return content_key(text) in self._store

    def encode(self, texts: Sequence[str], embedder: Callable) -> np.ndarray:
        """Embed ``texts``, calling ``embedder`` only on cache misses.

        Misses are deduplicated before the embedder call (one row per unique
        unseen content), then every position is served from the store.
        """
        if len(texts) == 0:
            return np.zeros((0, 0), dtype=np.float32)
        keys = [content_key(t) for t in texts]
        missing_pos: list[int] = []
        seen_missing: set[str] = set()
        for pos, k in enumerate(keys):
            if k not in self._store and k not in seen_missing:
                seen_missing.add(k)
                missing_pos.append(pos)
        if missing_pos:
            fresh = np.asarray(embedder([texts[p] for p in missing_pos]),
                               dtype=np.float32)
            if fresh.ndim != 2 or fresh.shape[0] != len(missing_pos):
                raise ValueError(
                    f"embedder returned shape {fresh.shape}; expected "
                    f"({len(missing_pos)}, D)")
            for row, pos in enumerate(missing_pos):
                self._store[keys[pos]] = fresh[row]
            self.encoded_rows += len(missing_pos)
            if self.hook is not None:
                self.hook([keys[p] for p in missing_pos], fresh)
        self.misses += len(missing_pos)
        self.hits += len(keys) - len(missing_pos)
        return np.stack([self._store[k] for k in keys]).astype(np.float32)


class CachingEmbedder:
    """Drop-in embedder callable routed through an ``EmbeddingCache``.

    ``Session.table(texts=..., embedder=...)`` wraps the user's embedder in
    one of these, so lazy ``SemanticTable.embeddings`` materialization and
    incremental ``append``/``update`` all share the session cache.
    """

    def __init__(self, cache: EmbeddingCache, embedder: Callable):
        self.cache = cache
        self.embedder = embedder

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        return self.cache.encode(texts, self.embedder)
