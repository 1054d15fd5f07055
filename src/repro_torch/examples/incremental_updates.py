"""Paper §3.1 update handling: tuple inserts with mini-batch K-means and
LLM-call cache reuse; deletes with marking + merge.

    PYTHONPATH=src python -m repro_torch.examples.incremental_updates

The k-means fit, the nearest-centroid assignment and the mini-batch step
run on the card (``main(device="cpu")`` for the CPU).
"""
import numpy as np
import torch

from repro_torch.core import CSVConfig, SemanticTable, SyntheticOracle
from repro_torch.core.clustering import (kmeans, kmeans_predict,
                                         minibatch_kmeans_update)
from repro_torch.core.operators import accuracy_f1
from repro_torch.data import make_dataset
from repro_torch.launch.serve import sem_filter
from repro_torch.utils.device import resolve_device


def main(device="cuda"):
    print("== incremental table maintenance ==")
    dev = resolve_device(device)
    ds = make_dataset("imdb_review", n=12000, seed=0)
    truth = ds.labels["RV-Q1"]
    base_n = 10000
    emb = ds.embeddings

    # initial offline clustering + filter over the first 10k tuples
    cents, assign, _ = kmeans(0, emb[:base_n], 4, device=dev)
    assign = assign.cpu().numpy()
    oracle = SyntheticOracle(truth, flip_prob=0.02, seed=7,
                             token_lens=ds.token_lens)
    table = SemanticTable(texts=ds.texts[:base_n], embeddings=emb[:base_n],
                          device=dev)
    r1 = sem_filter(table, oracle, method="csv", cfg=CSVConfig(n_clusters=4))
    print(f"initial filter: {r1.n_llm_calls} calls over {base_n} tuples")
    memo = oracle.memo_snapshot()

    # (1) small update: assign new tuples to nearest centroid, reuse votes
    small = np.arange(base_n, base_n + 500)
    new_assign = kmeans_predict(
        torch.from_numpy(emb[small]).to(dev), cents).cpu().numpy()
    # cluster-level label for each original cluster (majority of its mask)
    votes = {}
    for c in range(4):
        members = np.nonzero(assign == c)[0]
        votes[c] = bool(r1.mask[members].mean() > 0.5)
    small_labels = np.array([votes[a] for a in new_assign])
    acc_small = (small_labels == truth[small]).mean()
    print(f"small insert (500 tuples): 0 LLM calls, reuse cluster votes, "
          f"acc={acc_small:.4f}")

    # (2) larger periodic update: mini-batch K-means + cached-call reuse
    big = np.arange(base_n, 12000)
    counts = torch.from_numpy(
        np.bincount(assign, minlength=4).astype(np.float32)).to(dev)
    cents2, counts = minibatch_kmeans_update(
        cents, counts, torch.from_numpy(emb[big]).to(dev))
    assert int(counts.sum()) == 12000, "every tuple counted once"
    oracle2 = SyntheticOracle(truth, flip_prob=0.02, seed=7,
                              token_lens=ds.token_lens)
    oracle2.memo_restore(memo)  # cached LLM outcomes from the original run
    table2 = SemanticTable(texts=ds.texts, embeddings=emb, device=dev)
    r2 = sem_filter(table2, oracle2, method="csv",
                    cfg=CSVConfig(n_clusters=4))
    acc, f1 = accuracy_f1(r2.mask, truth)
    print(f"large update (12000 total): {oracle2.stats.n_calls} NEW calls "
          f"({oracle2.stats.n_cached} served from cache), acc={acc:.4f}")

    # (3) delete: mark + merge when clusters shrink
    keep = np.ones(12000, bool)
    keep[np.random.default_rng(0).choice(12000, 3000, replace=False)] = False
    print(f"delete 3000 tuples -> {keep.sum()} remain; clusters re-merged "
          f"on next periodic re-cluster (marked, not rebuilt)")
    return r1, r2


if __name__ == "__main__":
    main()
