"""Lazy queries: logical plans that touch the oracle only at ``.collect()``.

``TableHandle.filter(...)`` and ``.join(...)`` return query objects holding
a *logical* description — a ``repro_torch.plan`` expression (or a join predicate)
plus an optional ``ExecutionPolicy``.  Building, composing (``&``/``|``/
``~``), and ``.explain()``-ing queries issues zero semantic-filter oracle
calls beyond the optimizer's pilot; ``.collect()`` lowers to the existing
``PlanExecutor`` / ``sem_join`` / baseline machinery and returns a unified
``QueryResult``.

Explain/collect contract: ``.explain()`` runs the SAME pilot (same RNG
derivation) the collect-time optimizer would, caches the ``PreparedPlan``
on the query, and ``.collect()`` reuses it.  Pilot calls are memoized by
the oracle, so a collect preceded by explain consumes the flip-RNG stream
and reports the same call counts as a cold collect — bit-identity is
asserted in tests/test_torch_api.py.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.api.memo import ReuseView, oracle_identity
from repro_torch.api.policy import ExecutionPolicy, OracleBudgetError
from repro_torch.core.baselines import (BaselineResult, bargain_filter,
                                        lotus_filter, reference_filter)
from repro_torch.obs.audit import audit_query_result
from repro_torch.obs.trace import get_tracer
from repro_torch.plan.cost import est_oracle_calls
from repro_torch.plan.executor import PlanExecutor, PlanResult, PreparedPlan
from repro_torch.plan.expr import And, Expr, Not, Or, Pred, needs_ordering
from repro_torch.plan.join import JoinResult, sem_join
from repro_torch.plan.optimizer import NodeEstimate, node_estimates
from repro_torch.utils.timing import monotonic


# ------------------------------------------------------------------ results
@dataclasses.dataclass
class QueryResult:
    """Unified outcome of ``Query.collect()`` across all five methods and
    joins.  ``raw`` keeps the underlying result object (``PlanResult``,
    ``BaselineResult``, or ``JoinResult``) for path-specific detail."""
    kind: str                      # "filter" | "baseline" | "join"
    n_llm_calls: int               # oracle calls, pilot included
    pilot_calls: int
    n_proxy_calls: int
    input_tokens: int
    output_tokens: int
    order: list                    # executed leaf order (filters)
    node_log: list                 # per-leaf NodeRecord (plan path)
    round_log: Dict[str, list]     # per-leaf driver round logs
    total_time_s: float
    policy: ExecutionPolicy
    raw: Any
    mask: Optional[np.ndarray] = None       # filters/baselines
    pair_mask: Optional[np.ndarray] = None  # joins
    # tuples decided by replaying session-memoized decisions (zero oracle
    # cost; docs/caching.md) — 0 on cold runs and non-reuse paths
    n_replayed: int = 0
    # optimizer NodeEstimate per leaf (physical order) captured at collect
    # time — the predictions profile() confronts with the observed truth
    node_estimates: list = dataclasses.field(default_factory=list)
    # online audit outcome (repro_torch.obs.audit.AuditReport) — populated only
    # when the policy opted in via audit_rate > 0
    audit: Any = None

    def audit_report(self):
        """The online quality audit for this result (docs/observability.md).

        Requires the query to have run with ``ExecutionPolicy(audit_rate>0)``;
        the default policy never audits (and never spends audit calls).
        """
        if self.audit is None:
            raise ValueError(
                "no audit attached: run with ExecutionPolicy(audit_rate=...) "
                "> 0 to hold out a stratified audit sample at collect time")
        return self.audit

    @property
    def pairs(self) -> np.ndarray:
        if self.pair_mask is None:
            raise ValueError("pairs are only defined for join queries")
        return np.argwhere(self.pair_mask)

    def profile(self) -> str:
        """Estimated vs observed, per plan node.

        The ``explain()`` tree annotated with what actually happened: the
        optimizer's predicted oracle calls and selectivity next to the
        executed node's call count and observed pass rate (docs/observability.md).
        """
        lines = [f"QueryProfile({self.kind})  calls={self.n_llm_calls} "
                 f"(pilot {self.pilot_calls})  replayed={self.n_replayed}  "
                 f"wall={self.total_time_s:.3f}s"]
        est_by_name = {nd.name: nd for nd in self.node_estimates}
        for rec in self.node_log:
            nd = est_by_name.get(rec.name)
            obs_sel = rec.n_out / rec.n_in if rec.n_in else 0.0
            est_calls = "?" if nd is None else f"{nd.est_calls:.0f}"
            est_sel = ("?" if nd is None or nd.selectivity is None
                       else f"{nd.selectivity:.2f}")
            lines.append(
                f"  {rec.name:<16s} calls={rec.n_llm_calls:>6d} "
                f"(est {est_calls})  sel={obs_sel:.2f} (est {est_sel})  "
                f"in={rec.n_in} out={rec.n_out} "
                f"replayed={rec.n_replayed}")
        if not self.node_log:
            for nd in self.node_estimates:
                lines.append(f"  {nd.name:<16s} calls={self.n_llm_calls:>6d} "
                             f"(est {nd.est_calls:.0f})")
        return "\n".join(lines)


@dataclasses.dataclass
class Explain:
    """Rendered optimizer choice + per-node cost predictions (no cascade
    execution; the only oracle spend is the memoized pilot)."""
    kind: str
    method: str
    table: str
    n: int
    order: list
    naive_order: list
    nodes: list                    # NodeEstimate per leaf, physical order
    est_oracle_calls: float        # nodes + pilot
    pilot_calls: int
    estimate: Any                  # PlanEstimate | None
    text: str

    def __str__(self) -> str:
        return self.text


def _render_explain(ex: Explain, policy: ExecutionPolicy) -> str:
    lines = [f"Query({ex.kind}) on table {ex.table!r} (n={ex.n})  "
             f"method={ex.method} executor={policy.executor} "
             f"pipeline_depth={policy.pipeline_depth}"]
    if ex.order:
        lines.append("physical order: " + " -> ".join(ex.order)
                      + ("" if ex.order == ex.naive_order
                         else "   (naive: " + " -> ".join(ex.naive_order) + ")"))
    for nd in ex.nodes:
        sel = ("sel~?" if nd.selectivity is None
               else f"sel~{nd.selectivity:.2f}")
        lines.append(f"  {nd.name:<16s} est_in={nd.est_live_in:>8.0f}  "
                     f"est_oracle_calls={nd.est_calls:>8.0f}  {sel}")
    tail = f"est total {ex.est_oracle_calls:.0f} oracle calls"
    if ex.pilot_calls:
        tail += f" (incl. {ex.pilot_calls} pilot)"
    if ex.estimate is not None:
        tail += f"; naive order est {ex.estimate.est_calls_naive:.0f}"
    lines.append(tail)
    return "\n".join(lines)


def _snapshot(oracles: list) -> list:
    """(oracle, stats-clone) pairs for run-level accounting deltas."""
    return [(o, o.stats.clone()) for o in oracles
            if hasattr(o, "stats") and hasattr(o.stats, "clone")]


class Query:
    """Shared policy-resolution logic for filter and join queries."""

    def __init__(self, session, policy: Optional[ExecutionPolicy]):
        self.session = session
        self.policy = policy

    def _resolve(self, override: Optional[ExecutionPolicy]) -> ExecutionPolicy:
        pol = override or self.policy or self.session.policy
        if not isinstance(pol, ExecutionPolicy):
            raise TypeError(f"expected ExecutionPolicy, got {type(pol).__name__}")
        return pol

    def _check_budget(self, pol: ExecutionPolicy, est: float) -> None:
        if pol.max_oracle_calls is not None and est > pol.max_oracle_calls:
            raise OracleBudgetError(
                f"estimated {est:.0f} oracle calls exceed the policy budget "
                f"of {pol.max_oracle_calls} (closed-form pre-flight check; "
                "raise max_oracle_calls or shrink the query)")

    def worst_case_calls(self, policy: Optional[ExecutionPolicy] = None
                         ) -> float:
        """Closed-form worst-case oracle spend of ``collect`` under the
        resolved policy — zero oracle calls to compute.  This is the same
        estimate the ``max_oracle_calls`` pre-flight check uses; the
        service layer aggregates it per tenant for admission control."""
        pol = self._resolve(policy)
        self._validate(pol)
        return self._estimate_calls(pol)

    def _estimate_calls(self, pol: ExecutionPolicy) -> float:
        raise NotImplementedError


class FilterQuery(Query):
    """A lazy semantic filter over one table.

    ``expr`` is a ``repro_torch.plan`` expression; composition with ``&``/``|``/
    ``~`` builds a bigger logical plan (same table required) without any
    execution.  ``collect()`` routes on the resolved policy's ``method``:
    csv/csv-sim lower through ``PlanExecutor`` (cost-ordered short-circuit
    cascades), the three linear baselines call the corresponding
    ``repro_torch.core.baselines`` function on the single leaf's oracle.
    """

    def __init__(self, session, handle, expr: Expr,
                 policy: Optional[ExecutionPolicy] = None, proxy=None):
        super().__init__(session, policy)
        if not isinstance(expr, Expr):
            raise TypeError(f"expected a plan Expr, got {type(expr).__name__}")
        self.handle = handle
        self.expr = expr
        self.proxy = proxy
        # pilot probes keyed by (seed, pilot_size) — the only policy knobs
        # that change which ids the pilot draws; see _prepare()
        self._pilot_cache: Dict[tuple, Dict] = {}
        # raw fresh probes keyed by (seed, pilot_size, table version): the
        # truthful PredStats to reuse when a re-plan (different reuse
        # knobs, a scheduled clone) would otherwise re-probe a memo-warm
        # oracle and report pilot_calls=0 / default tokens (see _prepare)
        self._fresh_pilots: Dict[tuple, Dict] = {}

    # ------------------------------------------------------- composition
    def _combine(self, op, other: "FilterQuery") -> "FilterQuery":
        if not isinstance(other, FilterQuery):
            raise TypeError(f"cannot combine FilterQuery with "
                            f"{type(other).__name__}")
        if other.handle is not self.handle:
            raise ValueError("combined queries must target the same table "
                             f"({self.handle.name!r} vs {other.handle.name!r})")
        if (self.policy is not None and other.policy is not None
                and self.policy != other.policy):
            raise ValueError(
                "combined queries carry conflicting ExecutionPolicies; "
                "drop one or pass the policy to collect() instead")
        if (self.proxy is not None and other.proxy is not None
                and self.proxy is not other.proxy):
            raise ValueError("combined queries carry two different proxies")
        return FilterQuery(self.session, self.handle,
                           op(self.expr, other.expr),
                           policy=self.policy or other.policy,
                           proxy=self.proxy or other.proxy)

    def __and__(self, other: "FilterQuery") -> "FilterQuery":
        return self._combine(And, other)

    def __or__(self, other: "FilterQuery") -> "FilterQuery":
        return self._combine(Or, other)

    def __invert__(self) -> "FilterQuery":
        return FilterQuery(self.session, self.handle, Not(self.expr),
                           policy=self.policy, proxy=self.proxy)

    # -------------------------------------------------------- validation
    def _validate(self, pol: ExecutionPolicy) -> None:
        if pol.is_baseline:
            leaves = self.expr.leaves()
            if not isinstance(self.expr, Pred):
                raise ValueError(
                    f"method {pol.method!r} is a linear baseline and only "
                    f"supports a single bare predicate; this query composes "
                    f"{len(leaves)} leaves — use method='csv' or 'csv-sim'")
            if pol.method in ("lotus", "bargain") and self.proxy is None:
                raise ValueError(f"method {pol.method!r} requires a proxy "
                                 "model (pass proxy= to .filter())")

    def _reuse_view(self, pol: ExecutionPolicy) -> Optional[ReuseView]:
        """Session-memo binding for this query, or None when every reuse
        knob is off (or the method is a linear baseline)."""
        if pol.is_baseline or not (pol.reuse_memo or pol.reuse_stats):
            return None
        return ReuseView(self.session, self.handle,
                         reuse_decisions=pol.reuse_memo,
                         reuse_stats=pol.reuse_stats)

    def _estimate_calls(self, pol: ExecutionPolicy) -> float:
        """Closed-form worst case (no live-set shrinkage), zero oracle
        calls: per-leaf first-round estimate at full n, plus the pilot.

        Memo accounting: a leaf whose decisions replay from the session
        memo is budgeted at its *dirty-subset* size (zero on an unchanged
        table), and memoized pilot/observed statistics waive that leaf's
        pilot charge — so a warm replay fits budgets a cold run would
        blow."""
        n = len(self.handle)
        if pol.is_baseline:
            return float(n)
        cfg = pol.to_csv_config()
        view = self._reuse_view(pol)
        leaves = self.expr.leaves()
        est = 0.0
        need_pilot = set()
        for leaf in leaves:
            lcfg = leaf.cfg if leaf.cfg is not None else cfg
            hit = view.lookup(leaf, lcfg) if view is not None else None
            if hit is not None:
                est += est_oracle_calls(len(hit.rerun_rows), lcfg)
            else:
                est += est_oracle_calls(n, lcfg)
            # the pilot charge is waived only when planning actually has
            # memoized statistics for this leaf — a PARTIAL replay hit
            # (post-mutation) still re-probes, so it still pays
            if (view is None or view.pred_stats(leaf, lcfg, pol.seed,
                                                pol.pilot_size) is None):
                need_pilot.add(leaf.name)
        if pol.optimize and len(leaves) > 1:
            est += pol.pilot_size * len(need_pilot)
        return est

    # --------------------------------------------------------- planning
    def _executor(self, pol: ExecutionPolicy) -> PlanExecutor:
        return PlanExecutor(self.handle, cfg=pol.to_csv_config(),
                            optimize=pol.optimize, pilot_size=pol.pilot_size,
                            reuse_clustering=pol.reuse_clustering,
                            memo=self._reuse_view(pol))

    def _prepare(self, pol: ExecutionPolicy) -> PreparedPlan:
        """Plan (pilot + cost-ordering) under ``pol``.

        The pilot probe is cached by (seed, pilot_size) — the only knobs
        that change which ids it draws — so explain -> collect pays it
        exactly once even when the two resolve different policies; only the
        host-side cost-ordering is redone per policy.  Pilot oracle deltas
        are absorbed into the session aggregate HERE (collect's own
        snapshot window sees only the cascade).

        Session-memo reuse: leaves with memoized statistics (a replayable
        decision set, an observed selectivity, or a stored pilot probe at
        this table version) skip the fresh probe; only unknown leaves are
        piloted, and their fresh statistics are stored back into the memo
        for later queries.  With an empty memo every leaf is probed —
        bit-identical to a cold session."""
        ex = self._executor(pol)
        if not (pol.optimize and needs_ordering(self.expr)):
            return ex.prepare(self.expr)
        # the reuse knobs and the table version join the cache key:
        # memo-derived stats (replayable leaves, observed selectivities)
        # must never leak into a reuse-disabled prepare of the same query
        # object, and stats planned before an append()/update() must not
        # survive the mutation
        key = (pol.seed, pol.pilot_size, pol.reuse_memo, pol.reuse_stats,
               getattr(self.handle, "version", 0))
        pilot_stats = self._pilot_cache.get(key)
        if pilot_stats is None:
            view = self._reuse_view(pol)
            known: Dict[str, Any] = {}
            leaf_by_name: Dict[str, Any] = {}
            cfg = pol.to_csv_config()
            for leaf in self.expr.leaves():
                if leaf.name in leaf_by_name:
                    continue
                leaf_by_name[leaf.name] = leaf
                if view is not None:
                    ps = view.pred_stats(
                        leaf, leaf.cfg if leaf.cfg is not None else cfg,
                        pol.seed, pol.pilot_size)
                    if ps is not None:
                        known[leaf.name] = ps
            # pilot-accounting fix: a re-plan that resolves a different
            # cache key (reuse knobs toggled, a scheduled clone of the
            # query) must NOT probe again — by then the oracle memo is
            # warm, so a fresh probe would report pilot_calls=0 and fall
            # back to the default tokens_per_call, corrupting both the
            # cost ordering and the accounting.  Fresh probes are cached
            # under the only knobs that change the id draw and reused as
            # recorded (truthful calls/tokens).
            probed = self._fresh_pilots.setdefault(
                (pol.seed, pol.pilot_size,
                 getattr(self.handle, "version", 0)), {})
            tr = get_tracer()
            snap = _snapshot(self._oracles())
            with tr.span("pilot", kind="plan", pilot_size=pol.pilot_size,
                         n_fresh=len(leaf_by_name) - len(known)) as psp:
                fresh = ex.pilot(self.expr, skip=set(known) | set(probed))
            n_pilot = 0
            for oracle, before in snap:
                d = oracle.stats.delta(before)
                n_pilot += d.n_calls
                tr.metrics.inc("oracle.calls", d.n_calls)
                tr.metrics.inc("oracle.input_tokens", d.input_tokens)
                tr.metrics.inc("oracle.output_tokens", d.output_tokens)
                self.session._absorb(d)
            psp.set(calls=n_pilot)
            probed.update(fresh)
            if view is not None:
                for name, ps in probed.items():
                    if name not in known:
                        view.store_pilot(leaf_by_name[name], pol.seed,
                                         pol.pilot_size, ps)
            pilot_stats = {name: known.get(name) or probed[name]
                           for name in leaf_by_name}
            self._pilot_cache[key] = pilot_stats
        return ex.prepare(self.expr, pilot_stats=pilot_stats)

    def _oracles(self) -> list:
        """Distinct leaf oracles (LLM spend only; the proxy is accounted
        separately in ``session.proxy_stats``).  Dedup is by memo identity
        so two scheduler proxies over one oracle can never double-count a
        stats delta."""
        return list({id(oracle_identity(leaf.oracle)): leaf.oracle
                     for leaf in self.expr.leaves()}.values())

    def explain(self, policy: Optional[ExecutionPolicy] = None) -> Explain:
        """Render the optimizer's chosen ordering with pilot-based
        ``est_oracle_calls`` per node.  Pilot calls are memoized, so a
        subsequent ``.collect()`` is bit-identical to one without explain."""
        pol = self._resolve(policy)
        self._validate(pol)
        n = len(self.handle)
        if pol.is_baseline:
            name = self.expr.leaves()[0].name
            nodes = [NodeEstimate(name=name, est_live_in=float(n),
                                  est_calls=float(n), selectivity=None)]
            ex = Explain(kind="filter", method=pol.method,
                         table=self.handle.name, n=n, order=[name],
                         naive_order=[name], nodes=nodes,
                         est_oracle_calls=float(n), pilot_calls=0,
                         estimate=None, text="")
            ex.text = _render_explain(ex, pol)
            return ex
        prepared = self._prepare(pol)
        nodes = node_estimates(prepared.physical, n, prepared.pilot_stats,
                               pol.to_csv_config())
        pilot_calls = sum(s.pilot_calls
                          for s in prepared.pilot_stats.values())
        ex = Explain(kind="filter", method=pol.method, table=self.handle.name,
                     n=n, order=[p.name for p in prepared.physical.leaves()],
                     naive_order=[p.name for p in self.expr.leaves()],
                     nodes=nodes,
                     est_oracle_calls=sum(nd.est_calls for nd in nodes)
                     + pilot_calls,
                     pilot_calls=pilot_calls, estimate=prepared.estimate,
                     text="")
        ex.text = _render_explain(ex, pol)
        return ex

    # -------------------------------------------------------- execution
    def collect(self, policy: Optional[ExecutionPolicy] = None) -> QueryResult:
        pol = self._resolve(policy)
        self._validate(pol)
        self._check_budget(pol, self._estimate_calls(pol))
        tr = get_tracer()
        t0 = monotonic()
        with tr.span("query", kind="query", query="filter",
                     table=self.handle.name, method=pol.method) as qsp:
            # sight every leaf oracle as having touched this table EVEN when
            # reuse is off: TableHandle.update() must be able to invalidate
            # stale per-id oracle memos regardless of the policy the oracle
            # was used under.  Sightings are weak — they never extend oracle
            # lifetimes
            for oracle in self._oracles():
                self.session.memo.note_sighting(self.handle.name, oracle)
            # proxy spend is tracked separately (session.proxy_stats):
            # proxy calls are the cheap cascade model, not LLM-oracle spend
            proxy_snap = _snapshot([self.proxy]
                                   if self.proxy is not None else [])
            if pol.is_baseline:
                name = self.expr.leaves()[0].name
                n = len(self.handle)
                ests = [NodeEstimate(name=name, est_live_in=float(n),
                                     est_calls=float(n), selectivity=None)]
                snap = _snapshot(self._oracles())
                raw = self._run_baseline(pol, self.expr.leaves()[0].oracle)
            else:
                # plan first: _prepare absorbs any fresh pilot spend into
                # the session aggregate, so the snapshot below covers the
                # cascade
                prepared = self._prepare(pol)
                ests = node_estimates(prepared.physical, len(self.handle),
                                      prepared.pilot_stats,
                                      pol.to_csv_config())
                snap = _snapshot(self._oracles())
                raw = self._executor(pol).run(self.expr, prepared=prepared)
            for oracle, before in snap:
                self.session._absorb(oracle.stats.delta(before))
            for proxy, before in proxy_snap:
                self.session._absorb_proxy(proxy.stats.delta(before))
            res = self._to_result(pol, raw, monotonic() - t0, ests)
            if pol.audit_rate > 0.0 and res.mask is not None:
                # observation-only: audit spend lands under audit.* metrics
                # and the report — oracle stats/memo/RNG are untouched, so
                # the masks above (and every later query) stay bit-identical
                with tr.span("audit", kind="audit", table=self.handle.name):
                    res.audit = audit_query_result(self.handle, self.expr,
                                                   pol, res.mask)
            qsp.set(calls=res.n_llm_calls, n_replayed=res.n_replayed)
            tr.metrics.inc("query.collects")
        return res

    def _run_baseline(self, pol: ExecutionPolicy, oracle) -> BaselineResult:
        n = len(self.handle)
        if pol.method == "reference":
            return reference_filter(n, oracle)
        fn = lotus_filter if pol.method == "lotus" else bargain_filter
        return fn(n, self.proxy, oracle, **dict(pol.baseline))

    def _to_result(self, pol, raw, dt: float,
                   ests: Optional[list] = None) -> QueryResult:
        ests = ests or []
        if isinstance(raw, BaselineResult):
            name = self.expr.leaves()[0].name
            return QueryResult(
                kind="baseline", mask=raw.mask,
                n_llm_calls=raw.n_oracle_calls, pilot_calls=0,
                n_proxy_calls=raw.n_proxy_calls,
                input_tokens=raw.input_tokens,
                output_tokens=raw.output_tokens, order=[name], node_log=[],
                round_log={}, total_time_s=dt, policy=pol, raw=raw,
                node_estimates=ests)
        assert isinstance(raw, PlanResult)
        return QueryResult(
            kind="filter", mask=raw.mask, n_llm_calls=raw.n_llm_calls,
            pilot_calls=raw.pilot_calls, n_proxy_calls=0,
            input_tokens=raw.input_tokens, output_tokens=raw.output_tokens,
            order=list(raw.order), node_log=list(raw.node_log),
            round_log={name: fr.round_log for name, fr in raw.results.items()},
            total_time_s=dt, policy=pol, raw=raw,
            n_replayed=sum(rec.n_replayed for rec in raw.node_log),
            node_estimates=ests)


class JoinQuery(Query):
    """A lazy CSV-backed semantic join between two tables of one session."""

    def __init__(self, session, left, right, oracle,
                 policy: Optional[ExecutionPolicy] = None):
        super().__init__(session, policy)
        self.left = left
        self.right = right
        self.oracle = oracle

    def _validate(self, pol: ExecutionPolicy) -> None:
        if pol.method not in ("csv", "csv-sim"):
            raise ValueError(
                f"method {pol.method!r} is not supported for joins; the "
                "CSV-backed join runs under 'csv' (UniVote) or 'csv-sim' "
                "(SimVote pair embeddings)")

    def _estimate_calls(self, pol: ExecutionPolicy) -> float:
        """First-round closed form: every cluster-pair block pays at least
        one ``min_sample`` probe, capped by the total pair count.  A join
        whose pair decisions replay from the session memo is budgeted at
        zero (same accounting rule as replayable filter leaves)."""
        if (pol.reuse_memo and self.session.memo.lookup_join(
                self.left, self.right, self.oracle,
                pol.to_join_config()) is not None):
            return 0.0
        cfg = pol.to_join_config()
        n_pairs = len(self.left) * len(self.right)
        n_blocks = (min(cfg.n_clusters_left, len(self.left))
                    * min(cfg.n_clusters_right, len(self.right)))
        per = n_pairs / max(n_blocks, 1)
        return float(min(n_pairs, n_blocks
                         * max(cfg.min_sample, math.ceil(cfg.xi * per))))

    def explain(self, policy: Optional[ExecutionPolicy] = None) -> Explain:
        pol = self._resolve(policy)
        self._validate(pol)
        est = self._estimate_calls(pol)
        n_pairs = len(self.left) * len(self.right)
        name = f"{self.left.name} JOIN {self.right.name}"
        nodes = [NodeEstimate(name=name, est_live_in=float(n_pairs),
                              est_calls=est, selectivity=None)]
        ex = Explain(kind="join", method="csv-join", table=name, n=n_pairs,
                     order=[name], naive_order=[name], nodes=nodes,
                     est_oracle_calls=est, pilot_calls=0, estimate=None,
                     text="")
        ex.text = _render_explain(ex, pol)
        return ex

    def collect(self, policy: Optional[ExecutionPolicy] = None) -> QueryResult:
        pol = self._resolve(policy)
        self._validate(pol)
        self._check_budget(pol, self._estimate_calls(pol))
        tr = get_tracer()
        t0 = monotonic()
        name = f"{self.left.name} JOIN {self.right.name}"
        ests = [NodeEstimate(
            name=name, est_live_in=float(len(self.left) * len(self.right)),
            est_calls=self._estimate_calls(pol), selectivity=None)]
        with tr.span("query", kind="query", query="join",
                     table=name, method=pol.method) as qsp:
            # pair-oracle sightings: mutations of either side must clear
            # this oracle's memo outright (pair ids reindex; see
            # docs/caching.md)
            self.session.memo.note_pair_oracle(self.left.name, self.oracle)
            self.session.memo.note_pair_oracle(self.right.name, self.oracle)
            cfg = pol.to_join_config()
            if pol.reuse_memo:
                jm = self.session.memo.lookup_join(self.left, self.right,
                                                   self.oracle, cfg)
                if jm is not None:
                    # replay: same predicate, same join semantics, both
                    # tables unchanged — zero oracle calls, bit-identical
                    # pair mask
                    raw = JoinResult(
                        pair_mask=jm.pair_mask.copy(), n_llm_calls=0,
                        input_tokens=0, output_tokens=0, n_voted=0,
                        n_fallback=0, refine_rounds=0,
                        total_time_s=monotonic() - t0, round_log=[])
                    qsp.set(calls=0, n_replayed=int(raw.pair_mask.size))
                    tr.metrics.inc("query.collects")
                    tr.metrics.inc("memo.replays")
                    return QueryResult(
                        kind="join", pair_mask=raw.pair_mask, n_llm_calls=0,
                        pilot_calls=0, n_proxy_calls=0, input_tokens=0,
                        output_tokens=0, order=[name],
                        node_log=[], round_log={"join": []},
                        total_time_s=raw.total_time_s, policy=pol, raw=raw,
                        n_replayed=int(raw.pair_mask.size),
                        node_estimates=ests)
            assign_l = assign_r = None
            if pol.reuse_clustering:
                assign_l = self.left.precluster(cfg.n_clusters_left,
                                                cfg.seed)
                assign_r = self.right.precluster(cfg.n_clusters_right,
                                                 cfg.seed)
            snap = _snapshot([self.oracle])
            raw: JoinResult = sem_join(
                self.left.embeddings, self.right.embeddings, self.oracle,
                cfg, assign_left=assign_l, assign_right=assign_r,
                init_centroids=self.session.init_centroids,
                device=self.session.device)
            for oracle, before in snap:
                self.session._absorb(oracle.stats.delta(before))
            if pol.reuse_memo:
                # record for later replay (mirrors the filter-side rule:
                # recording is skipped only when reuse is pinned off)
                self.session.memo.record_join(self.left, self.right,
                                              self.oracle, cfg,
                                              raw.pair_mask)
            qsp.set(calls=raw.n_llm_calls)
            tr.metrics.inc("query.collects")
        return QueryResult(
            kind="join", pair_mask=raw.pair_mask,
            n_llm_calls=raw.n_llm_calls, pilot_calls=0, n_proxy_calls=0,
            input_tokens=raw.input_tokens, output_tokens=raw.output_tokens,
            order=[name], node_log=[],
            round_log={"join": raw.round_log},
            total_time_s=monotonic() - t0, policy=pol, raw=raw,
            node_estimates=ests)
