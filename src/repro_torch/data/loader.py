"""Deterministic sharded data loader with sequence packing.

Training substrate for the launcher and the example: packs token streams
into fixed (B, S) batches, shards deterministically by (host, step) so
every restart resumes at the exact batch (fault tolerance), and
prefetches on a thread.  The reference's, line for line (host numpy).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Sequence

import numpy as np


class PackedLoader:
    def __init__(self, docs_tokens: Sequence[List[int]], batch: int, seq: int,
                 pad_id: int = 0, seed: int = 0, host_id: int = 0,
                 n_hosts: int = 1, prefetch: int = 2):
        self.docs = list(docs_tokens)
        self.batch, self.seq = batch, seq
        self.pad_id = pad_id
        self.seed = seed
        self.host_id, self.n_hosts = host_id, n_hosts
        self.prefetch = prefetch
        self._stream_cache: dict[int, np.ndarray] = {}

    def _epoch_stream(self, epoch: int) -> np.ndarray:
        if epoch not in self._stream_cache:
            rng = np.random.default_rng(self.seed + epoch)
            order = rng.permutation(len(self.docs))
            flat: list[int] = []
            for i in order:
                flat.extend(self.docs[i])
            self._stream_cache = {epoch: np.asarray(flat, np.int32)}
        return self._stream_cache[epoch]

    def batch_at(self, step: int) -> dict:
        """Deterministic random access by global step (restart-safe)."""
        tokens_per_batch = self.batch * (self.seq + 1)
        global_off = step * tokens_per_batch * self.n_hosts \
            + self.host_id * tokens_per_batch
        epoch = 0
        stream = self._epoch_stream(epoch)
        while global_off + tokens_per_batch >= len(stream) * (epoch + 1):
            epoch += 1
            if epoch > 1000:
                break
        stream = self._epoch_stream(epoch)
        off = global_off % max(1, len(stream) - tokens_per_batch - 1)
        chunk = stream[off: off + tokens_per_batch]
        if len(chunk) < tokens_per_batch:
            chunk = np.pad(chunk, (0, tokens_per_batch - len(chunk)),
                           constant_values=self.pad_id)
        arr = chunk.reshape(self.batch, self.seq + 1)
        return {"tokens": arr[:, :-1].copy(), "targets": arr[:, 1:].copy()}

    def iterate(self, start_step: int = 0) -> Iterator[dict]:
        """Prefetching iterator starting at an arbitrary step."""
        q: "queue.Queue[dict]" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            step = start_step
            while not stop.is_set():
                q.put(self.batch_at(step))
                step += 1

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
