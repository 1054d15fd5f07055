"""BM25 lexical features + hybrid clustering distance (paper §4.1).

The paper mixes lambda * L2(embedding) + (1-lambda) * BM25 distance for
lexically-anchored predicates.  K-means needs a vector space, so we embed
BM25 as a hashed tf-idf-weighted bag-of-words vector and cluster in the
*concatenated* space  [sqrt(lambda) * emb ; sqrt(1-lambda) * bm25_vec]:
squared L2 there equals the weighted sum of the two squared distances —
the same monotone combination the paper uses (adaptation noted in
DESIGN.md §3).
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from repro_torch.data.tokenizer import HashTokenizer


def bm25_vectors(texts: Sequence[str], dim: int = 256, k1: float = 1.5,
                 b: float = 0.75, tokenizer: HashTokenizer = None
                 ) -> np.ndarray:
    """Hashed BM25-weighted term vectors, L2-normalized. (N, dim)."""
    tok = tokenizer or HashTokenizer()
    docs = [tok.words(t) for t in texts]
    n = len(docs)
    avgdl = max(1.0, float(np.mean([len(d) for d in docs])))
    # document frequency per hashed slot
    df = np.zeros(dim, np.float64)
    hashed_docs = []
    for d in docs:
        ids = np.asarray([tok.token_id(w) % dim for w in d], np.int64) \
            if d else np.zeros(0, np.int64)
        hashed_docs.append(ids)
        if len(ids):
            df[np.unique(ids)] += 1
    idf = np.log(1 + (n - df + 0.5) / (df + 0.5))

    out = np.zeros((n, dim), np.float32)
    for i, ids in enumerate(hashed_docs):
        if not len(ids):
            continue
        tf = np.bincount(ids, minlength=dim).astype(np.float64)
        dl = len(ids)
        w = idf * tf * (k1 + 1) / (tf + k1 * (1 - b + b * dl / avgdl))
        norm = math.sqrt(float(np.sum(w * w)))
        out[i] = (w / max(norm, 1e-9)).astype(np.float32)
    return out


def hybrid_features(embeddings: np.ndarray, texts: Sequence[str],
                    lam: float = 1.0, bm25_dim: int = 256) -> np.ndarray:
    """Concatenated feature space realizing lambda*L2 + (1-lambda)*BM25."""
    emb = np.asarray(embeddings, np.float32)
    if lam >= 1.0:
        return emb
    # scale embedding part to unit-ish norm so lambda weights are meaningful
    emb_n = emb / max(1e-9, float(np.median(np.linalg.norm(emb, axis=1))))
    bv = bm25_vectors(texts, dim=bm25_dim)
    return np.concatenate([math.sqrt(lam) * emb_n,
                           math.sqrt(1.0 - lam) * bv], axis=1)
