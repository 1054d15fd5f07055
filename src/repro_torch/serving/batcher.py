"""Continuous-batching-lite: padded length buckets for prompt batches.

TPU serving wants static shapes; requests are grouped into power-of-two
length buckets and padded batches, so each (bucket_len, batch) pair hits a
cached compiled program.  This is the fixed-shape analogue of vLLM's
continuous batching used by the paper's serving layer.
"""
from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

import numpy as np


def bucket_len(n: int, min_bucket: int = 32, max_bucket: int = 8192) -> int:
    return min(max_bucket, max(min_bucket, 1 << math.ceil(math.log2(max(1, n)))))


class DispatchMergeStats:
    """Fill accounting for merged cross-query oracle dispatches.

    The service scheduler's analogue of ``BucketBatcher.stats``: where the
    bucket batcher measures how well one query's prompts fill padded device
    batches, this measures how well concurrent queries fill each *oracle
    invocation* — one ``record`` per merged dispatch, holding the batch
    size each member request contributed.  ``mean_batch_size`` is the
    number the ISSUE-5 acceptance criterion compares against the serial
    per-invocation mean (``OracleStats.mean_batch_size``)."""

    def __init__(self):
        # running counters, NOT per-dispatch lists: a long-lived service
        # records one entry per tick forever, so growth must be O(1)
        self.n_invocations = 0
        self.n_requests = 0
        self.total_ids = 0
        self.last_invocation = 0   # merged ids in the most recent dispatch
        self.total_wall_s = 0.0    # evaluation wall-clock across dispatches
        self.last_wall_s = 0.0
        self.total_tokens = 0      # oracle tokens (input + decision) spent
        self.n_truncated = 0       # prompts left-truncated by the batcher

    def record(self, sizes: Iterable[int], wall_s: float = 0.0,
               tokens: int = 0, truncated: int = 0) -> None:
        sizes = [int(s) for s in sizes]
        self.n_invocations += 1
        self.n_requests += len(sizes)
        self.last_invocation = sum(sizes)
        self.total_ids += self.last_invocation
        self.last_wall_s = float(wall_s)
        self.total_wall_s += float(wall_s)
        self.total_tokens += int(tokens)
        self.n_truncated += int(truncated)

    @property
    def mean_batch_size(self) -> float:
        """Mean merged ids per dispatch (0.0 before the first record)."""
        if not self.n_invocations:
            return 0.0
        return self.total_ids / self.n_invocations

    @property
    def merge_factor(self) -> float:
        """Mean member requests folded into one dispatch (>= 1.0)."""
        if not self.n_invocations:
            return 0.0
        return self.n_requests / self.n_invocations

    @property
    def mean_wall_s(self) -> float:
        """Mean evaluation wall-clock per dispatch (tick wave)."""
        if not self.n_invocations:
            return 0.0
        return self.total_wall_s / self.n_invocations

    @property
    def tokens_per_s(self) -> float:
        """Oracle token throughput over the recorded evaluation time."""
        if self.total_wall_s <= 0:
            return 0.0
        return self.total_tokens / self.total_wall_s

    def metrics_view(self) -> dict:
        """Unified-name view for ``MetricsRegistry.sync_from``."""
        return {
            "service.invocations": self.n_invocations,
            "service.requests": self.n_requests,
            "service.merged_ids": self.total_ids,
            "service.tokens": self.total_tokens,
            "service.truncated": self.n_truncated,
            "service.mean_batch_size": self.mean_batch_size,
            "service.merge_factor": self.merge_factor,
            "service.tokens_per_s": self.tokens_per_s,
            "service.last_invocation": self.last_invocation,
            "service.last_wall_s": self.last_wall_s,
        }


class BucketBatcher:
    def __init__(self, max_batch: int = 32, pad_id: int = 0,
                 min_bucket: int = 32, max_bucket: int = 8192):
        self.max_batch = max_batch
        self.pad_id = pad_id
        self.min_bucket = min_bucket
        self.max_bucket = max_bucket
        # cumulative planning stats: how well callers fill the buckets.
        # The CSV round executor exists to push fill_ratio toward 1.0 —
        # cross-cluster batches arrive max_batch-sized instead of per-cluster
        # trickles; benchmarks and the round planner read these numbers.
        self.stats = {"plans": 0, "prompts": 0, "batches": 0,
                      "padded_tokens": 0, "real_tokens": 0,
                      # overlong prompts silently lose their head (left
                      # truncation keeps the answer-bearing tail); count
                      # both events and tokens so the loss is visible
                      "truncated_prompts": 0, "truncated_tokens": 0}

    @property
    def mean_batch_size(self) -> float:
        return self.stats["prompts"] / max(1, self.stats["batches"])

    @property
    def fill_ratio(self) -> float:
        """Fraction of padded (batch x bucket_len) slots holding real tokens."""
        return self.stats["real_tokens"] / max(1, self.stats["padded_tokens"])

    def metrics_view(self) -> dict:
        """Unified-name view for ``MetricsRegistry.sync_from``."""
        return {
            "engine.plans": self.stats["plans"],
            "engine.prompts": self.stats["prompts"],
            "engine.batches": self.stats["batches"],
            "engine.padded_tokens": self.stats["padded_tokens"],
            "engine.real_tokens": self.stats["real_tokens"],
            "engine.truncated_prompts": self.stats["truncated_prompts"],
            "engine.truncated_tokens": self.stats["truncated_tokens"],
            "engine.bucket_fill": self.fill_ratio,
        }

    def plan(self, prompts: Sequence[List[int]]
             ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Group prompts -> [(orig_indices, tokens (b, L), lengths (b,))]."""
        order = np.argsort([len(p) for p in prompts], kind="stable")
        batches = []
        i = 0
        while i < len(order):
            j = min(i + self.max_batch, len(order))
            idx = order[i:j]
            L = bucket_len(max(len(prompts[k]) for k in idx),
                           self.min_bucket, self.max_bucket)
            toks = np.full((len(idx), L), self.pad_id, np.int32)
            lens = np.zeros(len(idx), np.int32)
            for r, k in enumerate(idx):
                p = prompts[k][-L:]  # truncate overlong from the left
                if len(prompts[k]) > L:
                    self.stats["truncated_prompts"] += 1
                    self.stats["truncated_tokens"] += len(prompts[k]) - L
                toks[r, :len(p)] = p
                lens[r] = len(p)
            batches.append((idx, toks, lens))
            self.stats["batches"] += 1
            self.stats["padded_tokens"] += len(idx) * L
            self.stats["real_tokens"] += int(lens.sum())
            i = j
        self.stats["plans"] += 1
        self.stats["prompts"] += len(prompts)
        return batches
