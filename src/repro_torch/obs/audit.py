"""Online quality auditing: does the xi/epsilon guarantee hold *right now*?

CSV's promise is statistical — sublinear oracle calls with a bounded error
rate — but nothing in the serving stack measured whether the guarantee
actually holds on a live workload.  ``ExecutionPolicy(audit_rate=...)``
opts a query into an online audit: after the voted mask is produced,
``audit_query_result`` draws a small **stratified, seeded** audit sample
(proportional across the query's clusters), labels it with the **real
oracle**, and compares against the CSV-voted labels.  The result is an
``AuditReport`` with Wilson-interval accuracy/precision/recall/F1
estimates, per-cluster disagreement rates, and the clusters whose observed
error breaches the configured bound (candidates for re-vote/re-cluster).

Isolation contract (the whole point of this module living in ``obs``):

- audit labeling never writes the oracle's memo, never touches
  ``oracle.stats``, and snapshots/restores the oracle's RNG stream (the
  synthetic flip stream) around its ``_evaluate`` call — so a run with
  auditing on produces **bit-identical masks and oracle-call counts** to
  the same run with auditing off, and every query that follows is
  unperturbed;
- audit spend is accounted only under ``audit.*`` metrics
  (``audit.calls``, ``audit.cached``, ``audit.input_tokens``) and the
  report itself — never ``oracle.*``;
- the audit sample is drawn from its own seeded stream
  (``[audit_seed, _AUDIT_STREAM]``), independent of the driver, pilot,
  and flip streams (same idiom as the executor's ``_PILOT_STREAM``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.obs.trace import get_tracer

# independent seed-stream constant for the audit sampler (spawn-key idiom,
# like the executor's _PILOT_STREAM) — never shared with driver/pilot/flip
_AUDIT_STREAM = 0x5DEECE66
# clusters need at least this many audited rows before they can be flagged
MIN_CLUSTER_AUDIT = 5


def wilson_interval(k: int, n: int, z: float = 1.96):
    """Wilson score interval for a binomial proportion ``k/n``.

    Preferred over the normal approximation because it behaves at the
    boundaries (k=0, k=n) and at audit-sized n.  Returns ``(lo, hi)``;
    an empty sample is maximally uncertain: ``(0, 1)``.
    """
    if n <= 0:
        return 0.0, 1.0
    p = k / n
    denom = 1.0 + z * z / n
    center = (p + z * z / (2 * n)) / denom
    half = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / denom
    return max(0.0, center - half), min(1.0, center + half)


def _f1(p: float, r: float) -> float:
    return 0.0 if p + r == 0 else 2 * p * r / (p + r)


@dataclasses.dataclass
class AuditReport:
    """Outcome of one online audit (``QueryResult.audit_report()``)."""
    n_rows: int                 # table rows the query decided
    n_audited: int              # stratified audit sample size
    n_agree: int                # audited rows where voted == oracle label
    n_fresh_calls: int          # oracle rows labeled fresh (audit.calls)
    n_memo_hits: int            # audited rows answered from the oracle memo
    input_tokens: int           # audit-only token spend
    error_bound: float          # tolerated disagreement rate (xi-bound)
    accuracy: float
    accuracy_lo: float
    accuracy_hi: float
    precision: float
    precision_lo: float
    precision_hi: float
    recall: float
    recall_lo: float
    recall_hi: float
    f1: float
    f1_lo: float
    f1_hi: float
    # clusters whose audited disagreement rate exceeds error_bound (with
    # >= MIN_CLUSTER_AUDIT audited rows): candidates for re-vote/re-cluster
    flagged_clusters: List[Dict[str, Any]]
    sample_ids: np.ndarray      # the audited row ids (seeded, reproducible)

    @property
    def breached(self) -> bool:
        """True when the audit is *confident* the guarantee is violated:
        even the optimistic end of the accuracy interval falls below
        ``1 - error_bound``, or a specific cluster breached the bound."""
        return (self.accuracy_hi < 1.0 - self.error_bound
                or bool(self.flagged_clusters))

    def __str__(self) -> str:
        lines = [
            f"AuditReport  n={self.n_audited}/{self.n_rows} audited  "
            f"calls={self.n_fresh_calls} (+{self.n_memo_hits} memo)  "
            f"bound={self.error_bound:g}  "
            f"{'BREACH' if self.breached else 'ok'}",
            f"  accuracy  {self.accuracy:.3f}  "
            f"[{self.accuracy_lo:.3f}, {self.accuracy_hi:.3f}]",
            f"  precision {self.precision:.3f}  "
            f"[{self.precision_lo:.3f}, {self.precision_hi:.3f}]",
            f"  recall    {self.recall:.3f}  "
            f"[{self.recall_lo:.3f}, {self.recall_hi:.3f}]",
            f"  f1        {self.f1:.3f}  "
            f"[{self.f1_lo:.3f}, {self.f1_hi:.3f}]",
        ]
        for fc in self.flagged_clusters:
            lines.append(
                f"  cluster {fc['cluster']}: {fc['disagree']}/{fc['n']} "
                f"disagree (rate {fc['rate']:.3f}) -> re-vote candidate")
        return "\n".join(lines)


# ------------------------------------------------------------ oracle side
def audit_labels(oracle, ids: np.ndarray):
    """Label ``ids`` with the real oracle **without perturbing it**.

    Memoized rows are answered from ``oracle._memo`` (the durable decision
    the query already paid for); the rest go through ``_evaluate`` directly
    — bypassing ``__call__`` so neither the memo nor ``oracle.stats`` move
    — with the oracle's RNG stream (synthetic flip noise) snapshotted and
    restored around the call.  Returns ``(labels, n_fresh, n_memo, tokens)``.
    """
    ids = np.asarray(ids, dtype=np.int64)
    out = np.zeros(len(ids), dtype=bool)
    memo = getattr(oracle, "_memo", {})
    missing: List[int] = []
    missing_pos: List[int] = []
    hits = 0
    for pos, i in enumerate(ids):
        v = memo.get(int(i))
        if v is None:
            missing.append(int(i))
            missing_pos.append(pos)
        else:
            out[pos] = v
            hits += 1
    tokens = 0
    if missing:
        mids = np.asarray(missing, dtype=np.int64)
        rng = getattr(oracle, "rng", None)
        state = rng.bit_generator.state if rng is not None else None
        try:
            labels = np.asarray(oracle._evaluate(mids), dtype=bool)
        finally:
            if state is not None:
                rng.bit_generator.state = state
        out[np.asarray(missing_pos, dtype=np.int64)] = labels
        try:
            tokens = int(oracle._tokens_of(mids))
        except Exception:  # noqa: BLE001 — the audit reports 0 tokens for
            # any oracle that cannot count them, as the reference does
            tokens = 0
    return out, len(missing), hits, tokens


def _eval_expr(expr, leaf_labels: Dict[str, np.ndarray]) -> np.ndarray:
    """Ground-truth composition of the query expression over per-leaf
    oracle labels (the logical semantics the cascade implements)."""
    # lazy import: repro_torch.plan transitively imports repro_torch.core,
    # which imports repro_torch.obs — a module-level import here would be
    # circular
    from repro_torch.plan.expr import And, Not, Or, Pred
    if isinstance(expr, Pred):
        return leaf_labels[expr.name]
    if isinstance(expr, Not):
        return ~_eval_expr(expr.child, leaf_labels)
    if isinstance(expr, And):
        out = _eval_expr(expr.children[0], leaf_labels)
        for c in expr.children[1:]:
            out = out & _eval_expr(c, leaf_labels)
        return out
    if isinstance(expr, Or):
        out = _eval_expr(expr.children[0], leaf_labels)
        for c in expr.children[1:]:
            out = out | _eval_expr(c, leaf_labels)
        return out
    raise TypeError(f"cannot audit expression node {type(expr).__name__}")


# ------------------------------------------------------------- the auditor
def stratified_sample(assign: np.ndarray, rate: float, max_rows: int,
                      seed: int) -> np.ndarray:
    """Proportional per-cluster draw from an independent seeded stream.

    Every non-empty cluster contributes at least one row (so small
    clusters — where CSV's vote is weakest — are always represented);
    allocation is otherwise proportional to cluster size, capped at
    ``max_rows`` total.
    """
    n = len(assign)
    target = min(max_rows, max(1, int(math.ceil(rate * n))))
    rng = np.random.default_rng([seed, _AUDIT_STREAM])
    picks: List[np.ndarray] = []
    for c in np.unique(assign):
        ids = np.nonzero(assign == c)[0]
        k = min(len(ids), max(1, int(round(target * len(ids) / n))))
        picks.append(ids[rng.choice(len(ids), size=k, replace=False)])
    sample = np.unique(np.concatenate(picks))
    if len(sample) > max_rows:
        sample = sample[rng.choice(len(sample), size=max_rows,
                                   replace=False)]
        sample = np.sort(sample)
    return sample


def audit_query_result(handle, expr, pol,
                       mask: np.ndarray) -> Optional[AuditReport]:
    """Run the online audit for one collected filter query.

    Draws the stratified sample over ``handle``'s clustering (the same
    ``(n_clusters, seed)`` partition the driver used), labels it per leaf
    via :func:`audit_labels`, composes ground truth through the expression,
    and scores the voted ``mask`` against it.  Emits ``audit.*`` /
    ``quality.*`` metrics on the ambient tracer's registry.
    """
    n = len(mask)
    if n == 0 or pol.audit_rate <= 0.0:
        return None
    assign = np.asarray(handle.precluster(pol.n_clusters, pol.seed))
    sample = stratified_sample(assign, pol.audit_rate, pol.audit_max_rows,
                               pol.audit_seed)
    # ---- ground truth per leaf, composed through the expression ----
    leaf_labels: Dict[str, np.ndarray] = {}
    n_fresh = n_memo = tokens = 0
    for leaf in expr.leaves():
        if leaf.name in leaf_labels:
            continue
        labels, fresh, hits, tok = audit_labels(leaf.oracle, sample)
        leaf_labels[leaf.name] = labels
        n_fresh += fresh
        n_memo += hits
        tokens += tok
    truth = _eval_expr(expr, leaf_labels)
    voted = np.asarray(mask, dtype=bool)[sample]
    agree = voted == truth
    k, m = int(agree.sum()), len(sample)
    acc = k / m
    acc_lo, acc_hi = wilson_interval(k, m)
    # ---- precision/recall/F1 against the audited ground truth ----
    tp = int(np.sum(voted & truth))
    fp = int(np.sum(voted & ~truth))
    fn = int(np.sum(~voted & truth))
    prec = tp / (tp + fp) if tp + fp else 1.0
    rec = tp / (tp + fn) if tp + fn else 1.0
    p_lo, p_hi = wilson_interval(tp, tp + fp) if tp + fp else (0.0, 1.0)
    r_lo, r_hi = wilson_interval(tp, tp + fn) if tp + fn else (0.0, 1.0)
    bound = (pol.audit_error_bound if pol.audit_error_bound is not None
             else (pol.epsilon if pol.epsilon is not None else 0.05))
    # ---- per-cluster disagreement -> re-vote candidates ----
    flagged: List[Dict[str, Any]] = []
    s_assign = assign[sample]
    for c in np.unique(s_assign):
        in_c = s_assign == c
        n_c = int(in_c.sum())
        dis = int(np.sum(~agree[in_c]))
        rate = dis / n_c
        if n_c >= MIN_CLUSTER_AUDIT and rate > bound:
            flagged.append({"cluster": int(c), "n": n_c, "disagree": dis,
                            "rate": rate})
    report = AuditReport(
        n_rows=n, n_audited=m, n_agree=k, n_fresh_calls=n_fresh,
        n_memo_hits=n_memo, input_tokens=tokens, error_bound=float(bound),
        accuracy=acc, accuracy_lo=acc_lo, accuracy_hi=acc_hi,
        precision=prec, precision_lo=p_lo, precision_hi=p_hi,
        recall=rec, recall_lo=r_lo, recall_hi=r_hi,
        f1=_f1(prec, rec), f1_lo=_f1(p_lo, r_lo), f1_hi=_f1(p_hi, r_hi),
        flagged_clusters=flagged, sample_ids=sample)
    metrics = get_tracer().metrics
    metrics.inc("audit.calls", n_fresh)
    metrics.inc("audit.cached", n_memo)
    metrics.inc("audit.input_tokens", tokens)
    metrics.inc("quality.audited_rows", m)
    metrics.inc("quality.disagreements", m - k)
    metrics.set("quality.accuracy", acc)
    metrics.set("quality.accuracy_lo", acc_lo)
    if flagged:
        metrics.inc("quality.flagged_clusters", len(flagged))
    if report.breached:
        metrics.inc("quality.audit_breaches")
    return report
