"""Semantic-operator table (Lotus-style): texts, embeddings and their
cached clusterings.

``SemanticTable`` holds texts + (lazily computed) embeddings.  Queries over
it go through ``repro_torch.api.Session``, which wraps a table in a
``TableHandle``; the table itself keeps the clustering cache the session
reads and the in-place mutations the handle drives.

A table's k-means (its pre-clustering and the nearest-centroid patches of
``append``/``update``) runs on its ``device`` with its seeder hook
``init_centroids``.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core.clustering import Seeder, assign_to_nearest, kmeans
from repro_torch.utils.device import resolve_device


class SemanticTable:
    """A table of tuples with text payloads and a semantic-filter operator.

    device: where its k-means runs (``"cuda"`` unless the caller asks for
    ``"cpu"``); init_centroids: the k-means seeder hook ``(seed, x, k) ->
    (k, D)`` (default ``repro_torch.core.clustering.plusplus_init``).
    """

    def __init__(self, texts: Optional[Sequence[str]] = None, embeddings=None,
                 embedder: Optional[Callable] = None, *,
                 init_centroids: Optional[Seeder] = None, device="cuda"):
        if texts is None and embeddings is None:
            raise ValueError("SemanticTable needs texts and/or embeddings")
        self.device = resolve_device(device)
        self.init_centroids = init_centroids
        self.texts = list(texts) if texts is not None else None
        self._embeddings = (np.asarray(embeddings, np.float32)
                            if embeddings is not None else None)
        self._embedder = embedder
        # per-instance clustering cache keyed by (n_clusters, seed),
        # holding (assignment, centroids): centroids stay around so table
        # mutations can patch the assignment incrementally (nearest-centroid)
        # instead of re-running k-means.  The session layer keys its cache by
        # (table id, n_clusters, seed) and delegates computation here, so
        # both stay coherent.
        self._assign_cache: dict[tuple[int, int],
                                 tuple[np.ndarray, np.ndarray]] = {}

    def __len__(self):
        if self.texts is not None:
            return len(self.texts)
        return len(self._embeddings)

    @property
    def embeddings(self) -> np.ndarray:
        if self._embeddings is None:
            if self._embedder is None:
                raise ValueError("table has no embeddings and no embedder")
            self._embeddings = np.asarray(self._embedder(self.texts), np.float32)
        return self._embeddings

    def precluster(self, n_clusters: int, seed: int = 0) -> np.ndarray:
        """Offline phase: cluster once, reuse across predicates."""
        return self.precluster_full(n_clusters, seed)[0]

    def precluster_full(self, n_clusters: int, seed: int = 0
                        ) -> tuple[np.ndarray, np.ndarray]:
        """(assignment, centroids) — centroids power incremental updates."""
        key = (n_clusters, seed)
        if key not in self._assign_cache:
            cents, assign, _ = kmeans(seed, self.embeddings, n_clusters,
                                      init_centroids=self.init_centroids,
                                      device=self.device)
            self._assign_cache[key] = (assign.cpu().numpy(),
                                       cents.cpu().numpy())
        return self._assign_cache[key]

    # --------------------------------------------------- incremental updates
    # Plumbing for ``repro_torch.api.TableHandle.append``/``update``: mutate
    # the payload in place and PATCH every cached clustering (new/changed rows
    # join the nearest existing centroid) instead of dropping it.  Returns
    # {(n_clusters, seed): (patched assignment, touched cluster ids)} so the
    # session layer can refresh its own cache and mark clusters dirty.

    def _append_rows(self, texts: Optional[Sequence[str]],
                     embeddings: Optional[np.ndarray]) -> dict:
        # validate EVERYTHING before mutating: a partial append (texts
        # extended, embeddings not) would corrupt the table invariant
        new = (np.asarray(embeddings, np.float32)
               if embeddings is not None else None)
        if self.texts is not None and texts is None:
            raise ValueError("table holds texts; append needs texts=")
        if self.texts is None and texts is not None:
            # mirror of _update_rows' "no texts to update": silently
            # dropping the payloads would orphan the appended rows
            raise ValueError("table has no texts; append embeddings only")
        if texts is not None and new is not None and len(texts) != len(new):
            raise ValueError(f"append got {len(texts)} texts but "
                             f"{len(new)} embedding rows")
        if self._embeddings is None:
            if new is not None:
                # silently dropping them would re-embed these rows from
                # text later, diverging from what the caller supplied
                raise ValueError(
                    "table embeddings are still lazy; materialize them "
                    "first (access .embeddings) or append texts only")
            self.texts.extend(texts)
            return {}  # embeddings still lazy: nothing clustered yet
        if new is None:
            raise ValueError("table has materialized embeddings; append "
                             "needs embeddings (or an embedder)")
        if new.ndim != 2 or new.shape[1] != self._embeddings.shape[1]:
            raise ValueError(f"append embeddings have shape {new.shape}; "
                             f"expected (*, {self._embeddings.shape[1]})")
        if self.texts is not None:
            self.texts.extend(texts)
        touched: dict = {}
        for key, (assign, cents) in self._assign_cache.items():
            add = assign_to_nearest(new, cents, device=self.device)
            patched = np.concatenate([assign, add])
            self._assign_cache[key] = (patched, cents)
            touched[key] = (patched, np.unique(add))
        self._embeddings = np.concatenate([self._embeddings, new])
        return touched

    def _update_rows(self, ids: np.ndarray, texts: Optional[Sequence[str]],
                     embeddings: Optional[np.ndarray]) -> dict:
        # validate EVERYTHING before mutating (same rule as _append_rows):
        # a partial update would leave new texts against old embeddings
        ids = np.asarray(ids, dtype=np.int64)
        new = (np.asarray(embeddings, np.float32)
               if embeddings is not None else None)
        if texts is not None and self.texts is None:
            raise ValueError("table has no texts to update")
        if texts is not None and len(texts) != len(ids):
            raise ValueError(f"update got {len(ids)} ids but "
                             f"{len(texts)} texts")
        if new is not None and len(new) != len(ids):
            # numpy would silently broadcast/partially assign otherwise
            raise ValueError(f"update got {len(ids)} ids but "
                             f"{len(new)} embedding rows")
        if new is not None and self._embeddings is None:
            raise ValueError(
                "table embeddings are still lazy; materialize them first "
                "(access .embeddings) or update texts only")
        if new is not None and (new.ndim != 2
                                or new.shape[1] != self._embeddings.shape[1]):
            raise ValueError(f"update embeddings have shape {new.shape}; "
                             f"expected (*, {self._embeddings.shape[1]})")
        if len(ids) and (ids.min() < 0 or ids.max() >= len(self)):
            raise IndexError(f"update ids out of range for table of "
                             f"{len(self)} rows")
        if texts is not None:
            for i, t in zip(ids, texts):
                self.texts[int(i)] = t
        if new is None:
            return {}
        touched: dict = {}
        for key, (assign, cents) in self._assign_cache.items():
            old_clusters = np.unique(assign[ids])
            add = assign_to_nearest(new, cents, device=self.device)
            patched = assign.copy()
            patched[ids] = add
            self._assign_cache[key] = (patched, cents)
            touched[key] = (patched,
                            np.unique(np.concatenate([old_clusters, add])))
        self._embeddings[ids] = new
        return touched


def accuracy_f1(pred: np.ndarray, truth: np.ndarray) -> tuple[float, float]:
    """The paper's quality metrics."""
    pred = np.asarray(pred, bool)
    truth = np.asarray(truth, bool)
    acc = float(np.mean(pred == truth))
    tp = float(np.sum(pred & truth))
    fp = float(np.sum(pred & ~truth))
    fn = float(np.sum(~pred & truth))
    prec = tp / max(tp + fp, 1e-9)
    rec = tp / max(tp + fn, 1e-9)
    f1 = 2 * prec * rec / max(prec + rec, 1e-9)
    return acc, f1
