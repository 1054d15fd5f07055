"""Synthetic analogues of the paper's five datasets.

No public datasets ship in the offline image, so each dataset is generated
with *controllable semantic structure* that matches the paper's measured
properties (DESIGN.md §9):

- topic clusters in embedding space with per-cluster label purity
  (Fig. 1(c)/(d): most clusters dominated by one label, some impure);
- label-agreement probability decaying with embedding distance (Fig. 2);
- per-query selectivity (e.g. CB-Q1's 3.3% rare-positive pathology);
- text payloads whose vocabulary correlates with the latent topic, so BM25
  and the hashing tokenizer see consistent lexical structure.

Embeddings are produced by the same generative model that drives labels,
playing the role of the frozen E5 encoder: e_i = topic_center + noise.
The ModelOracle path instead embeds real generated text with
repro.embeddings — used in examples/ and integration tests.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

_TOPIC_WORDS = {
    "review_pos": "brilliant outstanding moving superb delightful masterpiece "
                  "wonderful charming gripping excellent".split(),
    "review_neg": "dull boring dreadful awful tedious disappointing weak "
                  "lifeless shallow terrible".split(),
    "dialog_book": "book flight reservation confirm depart arrive ticket seat "
                   "fare economy".split(),
    "dialog_cancel": "cancel refund existing reservation void drop forfeit "
                     "terminate".split(),
    "code": "python compiler debugging algorithm database software developer "
            "framework engineer code".split(),
    "social": "twitter profile link follow instagram facebook channel blog "
              "subscribe page".split(),
    "hate": "hate stupid idiot trash ugly loser pathetic disgusting".split(),
    "neutral": "weather lunch travel music garden coffee morning friendly "
               "holiday sunny".split(),
    "fact": "claim evidence wikipedia states according record document "
            "verified source study".split(),
}


@dataclasses.dataclass
class SynthDataset:
    name: str
    texts: List[str]
    embeddings: np.ndarray  # (N, D) — "offline E5" embeddings
    labels: Dict[str, np.ndarray]  # per-query ground truth
    selectivity: Dict[str, float]
    token_lens: np.ndarray
    topics: np.ndarray


def _gen_topic_text(rng, words, neutral, n_words):
    k = rng.integers(3, max(4, n_words))
    picks = []
    for _ in range(k):
        pool = words if rng.random() < 0.55 else neutral
        picks.append(pool[rng.integers(0, len(pool))])
    return " ".join(picks)


def make_dataset(name: str, n: int = 4000, dim: int = 64, seed: int = 0,
                 n_topics: int = 8, purity: float = 0.97,
                 selectivity: Optional[float] = None,
                 cluster_scale: float = 1.0, noise: float = 0.35
                 ) -> SynthDataset:
    """Generate one dataset family.

    purity: per-topic majority-label fraction (drives Fig. 1(c/d) shapes).
    selectivity: overall positive rate of the primary query (None = topic-
    driven, ~balanced).  Low selectivity (e.g. 0.033) reproduces CB-Q1.
    """
    rng = np.random.default_rng(
        seed + int.from_bytes(name.encode()[:4].ljust(4, b"_"), "little") % 99991)
    spec = DATASETS[name]
    topic_names = spec["topics"]
    centers = rng.normal(0, cluster_scale, (n_topics, dim))
    topic_of = rng.integers(0, n_topics, n)
    emb = centers[topic_of] + rng.normal(0, noise, (n, dim))

    # mixed topics are a pair of label-opposed sub-Gaussians: coarse k-means
    # sees ONE impure cluster (Fig. 1(d) cluster 7), finer re-clustering
    # separates them (Table 4's accuracy recovery)
    if spec.get("impure_topics"):
        mixed = set(rng.choice(n_topics, size=max(1, n_topics // 4),
                               replace=False).tolist())
    else:
        mixed = set()
    sub_side = np.zeros(n, dtype=bool)
    for t in mixed:
        m = np.nonzero(topic_of == t)[0]
        u = rng.normal(0, 1, dim)
        u *= 0.9 * cluster_scale / np.linalg.norm(u)
        side = rng.random(len(m)) < 0.5
        emb[m] += np.where(side[:, None], u[None, :], -u[None, :])
        sub_side[m] = side

    # topic -> semantic word pool (cycled if n_topics > pools)
    pools = [_TOPIC_WORDS[t] for t in topic_names]
    neutral = _TOPIC_WORDS["neutral"]

    # Labels are *separable in embedding space*: each topic has a label
    # hyperplane; pure topics put most mass on one side (Fig. 1(c)), mixed
    # topics sit near 50/50 but remain separable by finer clustering —
    # which is exactly what makes the paper's re-clustering effective.
    def hyperplane_labels(frac_positive_per_topic, flip=0.02):
        lab = np.zeros(n, dtype=bool)
        for t in range(n_topics):
            m = topic_of == t
            if m.sum() == 0:
                continue
            fp0 = frac_positive_per_topic[t]
            if t in mixed and abs(fp0 - 0.5) < 0.2:
                lab[m] = sub_side[m]  # label = sub-Gaussian side (balanced q)
                continue
            w = rng.normal(0, 1, dim)
            w /= np.linalg.norm(w)
            proj = (emb[m] - centers[t]) @ w
            fp = frac_positive_per_topic[t]
            thresh = np.quantile(proj, 1.0 - fp) if 0 < fp < 1 else (
                np.inf if fp <= 0 else -np.inf)
            lab[m] = proj > thresh
        flips = rng.random(n) < flip
        return lab ^ flips

    topic_pos = (np.arange(n_topics) % 2 == 0)
    if selectivity is None:
        fracs = [purity if topic_pos[t] else 1.0 - purity
                 for t in range(n_topics)]
    else:
        # rare positives live in a sub-region of every topic (CB-Q1 style)
        fracs = [selectivity for _ in range(n_topics)]
    labels = hyperplane_labels(fracs, flip=max(0.0, 1.0 - purity) * 0.5)

    texts = []
    for i in range(n):
        pool = pools[topic_of[i] % len(pools)]
        # positives lean on the first half of the pool, negatives the second
        words = pool if labels[i] else pool[::-1]
        texts.append(_gen_topic_text(rng, words, neutral, spec["n_words"]))
    token_lens = np.array([len(t.split()) + 8 for t in texts])

    # secondary queries: other predicates over the same table.  Positives
    # occupy a *topic-aligned subregion*: whole topics are taken greedily up
    # to the target selectivity, with the residual mass carved from one
    # extra topic by a hyperplane slice.  Moderate selectivities are thus
    # cluster-separable (votable); rare ones (<1 topic) stay hard — the
    # paper's RV-Q3 / CB-Q1 regime.
    def topic_subset_labels(sel, flip):
        lab = np.zeros(n, dtype=bool)
        masses = np.array([(topic_of == t).mean() for t in range(n_topics)])
        order = rng.permutation(n_topics)
        acc = 0.0
        used = []
        for t in order:
            if acc + masses[t] <= sel + 1e-9:
                lab[topic_of == t] = True
                acc += masses[t]
                used.append(t)
        resid = sel - acc
        for t in order:
            if t in used or masses[t] == 0:
                continue
            m = topic_of == t
            frac = min(1.0, resid / masses[t])
            if frac > 1e-3:
                w = rng.normal(0, 1, dim)
                w /= np.linalg.norm(w)
                proj = (emb[m] - centers[t]) @ w
                lab[m] = proj > np.quantile(proj, 1 - frac)
            break
        return lab ^ (rng.random(n) < flip)

    all_labels = {spec["primary"]: labels}
    for qname, sel in spec.get("extra_queries", {}).items():
        flip = max(0.0, 1 - purity) * 0.5
        if sel is None:
            fr = [purity if rng.random() < 0.5 else 1 - purity
                  for _ in range(n_topics)]
            all_labels[qname] = hyperplane_labels(fr, flip=flip)
        else:
            all_labels[qname] = topic_subset_labels(sel, flip=flip)

    sels = {q: float(v.mean()) for q, v in all_labels.items()}
    return SynthDataset(name=name, texts=texts, embeddings=emb.astype(np.float32),
                        labels=all_labels, selectivity=sels,
                        token_lens=token_lens, topics=topic_of)


DATASETS = {
    # IMDB-Review: balanced sentiment, well-clustered for RV-Q1 (paper
    # Table 4: no re-clustering triggered on RV-Q1)
    "imdb_review": {
        "topics": ["review_pos", "review_neg"],
        "primary": "RV-Q1", "n_words": 24, "impure_topics": False,
        "extra_queries": {"RV-Q2": 0.35, "RV-Q3": 0.05},
    },
    # Codebase AboutMe: CB-Q1 rare positives (3.3%), CB-Q2/Q3 balanced-ish
    "codebase": {
        "topics": ["code", "social"],
        "primary": "CB-Q2", "n_words": 32, "impure_topics": True,
        "extra_queries": {"CB-Q1": 0.033, "CB-Q3": 0.3},
    },
    # Airdialogue: 4 one-vs-rest binary filters with skewed classes
    "airdialogue": {
        "topics": ["dialog_book", "dialog_cancel"],
        "primary": "AD-Q1", "n_words": 40, "impure_topics": False,
        "extra_queries": {"AD-Q2": 0.0146, "AD-Q3": 0.2308, "AD-Q4": 0.2389},
    },
    # TC hate speech: offensive language detection
    "tc": {
        "topics": ["hate", "neutral"],
        "primary": "TC", "n_words": 16, "impure_topics": True,
        "extra_queries": {},
    },
    # Fever: multi-column claim+evidence (fused embedding)
    "fever": {
        "topics": ["fact", "neutral"],
        "primary": "Fever", "n_words": 28, "impure_topics": False,
        "extra_queries": {},
    },
}

# per-dataset/query default hybrid-distance weight (paper §4.1: lambda=0.4
# for CB-Q1 and TC, 1.0 elsewhere)
DEFAULT_LAMBDA = {
    ("codebase", "CB-Q1"): 0.4,
    ("tc", "TC"): 0.4,
}
