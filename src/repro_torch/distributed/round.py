"""Sharded CSV rounds: how a round's clusters are split across shards.

With ``cfg.shards > 1`` the round executor of
``repro_torch.core.csv_filter`` splits each round with ``shard_clusters``
instead of into even waves.  The round plan (sample draws) is computed once
before the split, so every shard sees the same plan.  Each shard's sample
batch goes through one strict-FIFO oracle lane in shard order, each shard
votes its clusters in one segmented dispatch, and the outputs are written
back in shard order (== round cluster order).  The shards share one process
and one card, so that write-back is the gather.

Bit-identity contract (asserted in tests/test_torch_distributed_round.py):
masks, oracle call counts, cluster logs, and memo state equal the
``shards=1`` run on the same seed.  Only the per-invocation batch sizes
differ — one batch per shard instead of one per wave.
"""
from __future__ import annotations

import numpy as np


def shard_clusters(clusters: list, n_shards: int) -> list:
    """Contiguous, sample-count-balanced partition of a round's clusters.

    Contiguous slices (never an interleave) so that concatenating shard
    batches in shard order equals the single-host concatenation — the
    bit-identity contract depends on this.  Balanced on ``n_sample``
    because oracle cost, not cluster size, is what each shard pays.
    """
    n_shards = max(1, min(int(n_shards), len(clusters)))
    if n_shards == 1:
        return [list(clusters)]
    weights = np.array([cp.n_sample for cp in clusters], dtype=np.float64)
    cum = np.cumsum(weights)
    total = float(cum[-1])
    bounds = [0]
    for s in range(1, n_shards):
        cut = int(np.searchsorted(cum, total * s / n_shards, side="left")) + 1
        cut = max(bounds[-1], min(cut, len(clusters)))
        bounds.append(cut)
    bounds.append(len(clusters))
    shards = [list(clusters[bounds[s]:bounds[s + 1]])
              for s in range(n_shards)]
    return [s for s in shards if s]
