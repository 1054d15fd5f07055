"""repro_torch.api — the canonical declarative entry point (lazy
Session/Query).

    from repro_torch.api import ExecutionPolicy, Session

    sess = Session(policy=ExecutionPolicy(n_clusters=4, xi=0.005),
                   device="cuda")
    reviews = sess.table(texts=..., embeddings=..., name="reviews")

    q = reviews.filter("is positive", oracle) & ~reviews.filter("spam", o2)
    print(q.explain())          # optimizer order + est_oracle_calls per node
    r = q.collect()             # the ONLY step that spends oracle calls
    r.mask, r.n_llm_calls, sess.stats

Filters, expression cascades, joins, and the linear baselines
(reference/lotus/bargain) all route through the same two calls —
``.explain()`` / ``.collect()`` — under one ``ExecutionPolicy``.  See
docs/api.md.
"""
from repro_torch.api.memo import ReplayHit, ReuseView, SessionMemo
from repro_torch.api.policy import (BASELINE_METHODS, EXECUTORS, METHODS,
                                    ExecutionPolicy, OracleBudgetError)
from repro_torch.api.query import (Explain, FilterQuery, JoinQuery, Query,
                                   QueryResult)
from repro_torch.api.session import Session, TableHandle
from repro_torch.embeddings.cache import CachingEmbedder, EmbeddingCache

__all__ = [
    "BASELINE_METHODS", "EXECUTORS", "METHODS",
    "ExecutionPolicy", "OracleBudgetError",
    "Explain", "FilterQuery", "JoinQuery", "Query", "QueryResult",
    "Session", "TableHandle",
    "ReplayHit", "ReuseView", "SessionMemo",
    "CachingEmbedder", "EmbeddingCache",
]
