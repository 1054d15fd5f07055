"""The traffic generator: a frozen, vectorised copy of the synthetic
datasets' generative model (topic blobs, impure topics split into two
label-opposed sub-Gaussians, per-topic label hyperplanes, a flip channel,
topic-correlated word pools), driven by a mix file's parameters.

The table (embeddings, topics, texts) comes from the mix's
``table_seed`` and the predicates' labels from its ``labels.seed``, so
every run of a cell, whatever its ``--seed``, filters the same table
with the same label sets and does the same work: with labels drawn from
the run's seed, a query needed one re-clustering round more on some
seeds than on others, and the seeds' runs differed by 5% in calls where
two runs of one seed agreed exactly.  Embeddings and labels are made on
the device in a few large calls; a text is made only when a prompt asks
for it, from its row's own generator.
"""
from __future__ import annotations

import numpy as np
import torch


def stream_seed(*parts: int) -> int:
    """A 63-bit seed for one stream, from any whole numbers."""
    return int(np.random.SeedSequence([int(p) % (1 << 64) for p in parts]
                                      ).generate_state(1, np.uint64)[0] >> 1)


class Table:
    """Embeddings (on the device and on the host), topics and lazy texts."""

    def __init__(self, mix: dict, device):
        t = mix["table"]
        self.mix = mix
        self.n, self.dim, self.n_topics = t["rows"], t["dim"], t["topics"]
        self.seed = t["table_seed"]
        g = torch.Generator(device=device).manual_seed(self.seed)
        scale, noise = t["cluster_scale"], t["noise"]
        self.centers = torch.randn((self.n_topics, self.dim), generator=g,
                                   device=device) * scale
        self.topic = torch.randint(0, self.n_topics, (self.n,), generator=g,
                                   device=device)
        emb = torch.randn((self.n, self.dim), generator=g, device=device)
        emb.mul_(noise).add_(self.centers[self.topic])
        # impure topics: two sub-Gaussians at +-u, 0.9 cluster scales apart
        # along a random direction (one coarse cluster, separable by a finer
        # re-clustering)
        n_mixed = max(1, self.n_topics // 4) if t["impure_topics"] else 0
        mixed = torch.randperm(self.n_topics, generator=g,
                               device=device)[:n_mixed]
        u = torch.randn((self.n_topics, self.dim), generator=g, device=device)
        u = u * (0.9 * scale / u.norm(dim=1, keepdim=True))
        side = torch.rand((self.n,), generator=g, device=device) < 0.5
        is_mixed = torch.zeros(self.n_topics, dtype=torch.bool,
                               device=device)
        is_mixed[mixed] = True
        sign = torch.where(side, 1.0, -1.0)[:, None]
        emb += torch.where(is_mixed[self.topic][:, None],
                           sign * u[self.topic], 0.0)
        self.emb = emb
        self.emb_host = emb.cpu().numpy()
        self.topic_host = self.topic.cpu().numpy()
        self.side_host = side.cpu().numpy()
        self.texts = LazyTexts(self, mix["text"])


class LazyTexts:
    """``texts[i]``: row i's post, 3 to n_words - 1 words, each from its
    topic's pool (the pool's first or second half by the row's
    sub-Gaussian side) with probability 0.55, else from the neutral pool."""

    def __init__(self, table: Table, spec: dict):
        self.table = table
        self.pools = [p.split() for p in spec["pools"]]
        self.neutral = spec["neutral"].split()
        self.n_words = spec["n_words"]

    def __len__(self) -> int:
        return self.table.n

    def __getitem__(self, i: int) -> str:
        i = int(i)
        rng = np.random.default_rng(stream_seed(self.table.seed, 1, i))
        pool = self.pools[int(self.table.topic_host[i]) % len(self.pools)]
        words = pool if self.table.side_host[i] else pool[::-1]
        k = rng.integers(3, max(4, self.n_words))
        out = []
        for _ in range(k):
            src = words if rng.random() < 0.55 else self.neutral
            out.append(src[rng.integers(0, len(src))])
        return " ".join(out)


def query_labels(table: Table, mix: dict, seed: int, q: int) -> np.ndarray:
    """Label set ``q`` drawn from ``seed``: in every topic a fresh
    random hyperplane puts the topic's share of positives (``purity`` in
    even topics, 1 - purity in odd ones: a balanced predicate whose
    clusters stay votable) on one side; then each label flips with
    probability (1 - purity) / 2."""
    lab = mix["labels"]
    dev = table.emb.device
    g = torch.Generator(device=dev).manual_seed(stream_seed(seed, 2, q))
    w = torch.randn((table.n_topics, table.dim), generator=g, device=dev)
    w = w / w.norm(dim=1, keepdim=True)
    proj = torch.einsum("nd,nd->n", table.emb - table.centers[table.topic],
                        w[table.topic])
    purity = lab["purity"]
    out = torch.zeros(table.n, dtype=torch.bool, device=dev)
    for t in range(table.n_topics):
        m = table.topic == t
        if not bool(m.any()):
            continue
        fp = purity if t % 2 == 0 else 1.0 - purity
        thr = torch.quantile(proj[m].double(), 1.0 - fp)
        out[m] = proj[m].double() > thr
    flips = torch.rand((table.n,), generator=g, device=dev) < (1 - purity) / 2
    return (out ^ flips).cpu().numpy()


def predicate(mix: dict, q: int) -> str:
    return mix["predicate"].format(q=q)
