"""Physical evaluation of predicate expressions: short-circuit CSV cascades.

The executor walks the (optimizer-ordered) tree and runs one CSV filter per
leaf **restricted to the tuples still alive at that node**:

- ``And``: tuples rejected by an earlier conjunct are masked out of later
  runs (``semantic_filter(subset_ids=...)``), so later clusters shrink and
  their samples — hence oracle calls — shrink with them.
- ``Or``: symmetric — tuples already accepted by an earlier disjunct are
  masked out.
- ``Not``: inverts the child's decisions on the live subset (no extra calls).

Every leaf reuses the table's precluster cache: the full-table k-means
assignment is computed once per (n_clusters, seed) and restricted to each
node's live subset, so cascading adds zero clustering work.

A bare ``Pred`` takes the exact ``sem_filter`` path (same precomputed
assignment, no pilot, no subset) and is bit-identical to it — masks and call
counts match under a fixed seed (tests/test_torch_plan.py).

Every leaf runs on the table's ``device`` with its k-means seeder
(``init_centroids``), so a cascade runs where the table's clustering did.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.core.csv_filter import (CSVConfig, FilterResult, replay_result,
                                         semantic_filter)
from repro_torch.obs.trace import get_tracer
from repro_torch.plan.cost import PredStats, pilot_predicates
from repro_torch.plan.expr import And, Expr, Not, Or, Pred, needs_ordering
from repro_torch.plan.optimizer import PlanEstimate, optimize
from repro_torch.utils.timing import monotonic

# decorrelates the pilot id draw from the CSV driver's cfg.seed stream
_PILOT_STREAM = 0x9E3779B9


@dataclasses.dataclass
class PreparedPlan:
    """Output of the planning phase (``PlanExecutor.prepare``).

    Splitting planning from execution lets ``repro_torch.api``'s ``.explain()``
    pay the pilot once and hand the SAME pilot statistics to the subsequent
    ``.collect()``: the pilot's oracle calls are memoized, so a collect that
    reuses a PreparedPlan consumes the flip-RNG stream exactly as a cold
    run would (the cold run's own pilot replays the memo), and the reported
    ``pilot_calls`` stay identical to the single-shot path.
    """
    physical: Expr                     # optimizer-ordered (or logical) tree
    estimate: Optional[PlanEstimate]   # None when no ordering choice existed
    pilot_stats: Dict[str, PredStats]


@dataclasses.dataclass
class NodeRecord:
    """One executed leaf: where it ran in the cascade and what it cost."""
    name: str
    n_in: int            # live tuples entering the node
    n_out: int           # tuples the node passed
    n_llm_calls: int
    input_tokens: int
    output_tokens: int
    result: Optional[FilterResult]
    # live tuples decided by replaying session-memoized decisions (zero
    # oracle cost); n_in - n_replayed tuples went through the CSV driver
    n_replayed: int = 0


@dataclasses.dataclass
class PlanResult:
    """Outcome of one plan execution (the expression-level FilterResult)."""
    mask: np.ndarray           # (N,) bool — tuples satisfying the expression
    n_llm_calls: int           # all nodes + pilot probes
    pilot_calls: int
    input_tokens: int
    output_tokens: int
    order: list                # leaf names in executed (physical) order
    naive_order: list          # leaf names in logical left-to-right order
    node_log: list             # NodeRecord per executed leaf
    results: Dict[str, FilterResult]  # per-predicate FilterResult (by name)
    estimate: Optional[PlanEstimate]  # None when no ordering choice existed
    pilot_stats: Dict[str, PredStats]
    total_time_s: float

    @property
    def est_calls_saved(self) -> float:
        """Optimizer-predicted oracle calls avoided vs. naive order."""
        if self.estimate is None:
            return 0.0
        return self.estimate.est_calls_naive - self.estimate.est_calls_ordered

    @property
    def est_tokens_saved(self) -> float:
        if self.estimate is None:
            return 0.0
        return (self.estimate.est_tokens_naive
                - self.estimate.est_tokens_ordered)


class PlanExecutor:
    """Evaluates a ``repro_torch.plan`` expression over one SemanticTable.

    table: anything with ``.embeddings``, ``.precluster(k, seed)``,
    ``.device``, ``.init_centroids`` and ``len()`` (duck-typed;
    ``repro_torch.core.operators.SemanticTable`` or an API table handle).
    optimize=False keeps the logical child order — the naive left-to-right
    cascade used as the benchmark baseline.
    """

    def __init__(self, table, cfg: Optional[CSVConfig] = None,
                 optimize: bool = True, pilot_size: int = 32,
                 reuse_clustering: bool = True, memo=None):
        self.table = table
        self.cfg = cfg or CSVConfig()
        self.optimize = optimize
        self.pilot_size = int(pilot_size)
        self.reuse_clustering = reuse_clustering
        # optional cross-query reuse hook (duck-typed; repro_torch.api.memo
        # binds the session memo here): ``lookup(leaf, cfg) -> ReplayHit |
        # None`` serves memoized decisions, ``record(leaf, cfg, fr, live)``
        # observes executed leaves.  None keeps the executor standalone.
        self.memo = memo
        self.n = len(table)

    def pilot(self, expr: Expr, skip=()) -> Dict[str, PredStats]:
        """Probe every unique leaf on the seed-derived pilot sample.  The
        draw depends only on (cfg.seed, pilot_size, n) — callers may cache
        the result under that key and re-plan with different cost-model
        knobs without touching the oracle again.  ``skip`` names leaves
        whose statistics the caller already has (session memo): the id draw
        is unchanged (probes are independent per leaf), so skipping keeps
        the probed leaves bit-identical to a full pilot."""
        rng = np.random.default_rng([self.cfg.seed, _PILOT_STREAM])
        leaves = [lf for lf in expr.leaves() if lf.name not in set(skip)]
        return pilot_predicates(leaves, np.arange(self.n), rng,
                                self.pilot_size)

    def prepare(self, expr: Expr,
                pilot_stats: Optional[Dict[str, PredStats]] = None
                ) -> PreparedPlan:
        """Planning phase only: pilot-sample and cost-order, no cascade run.

        Pilot oracle calls are spent here (and memoized); execution through
        ``run(expr, prepared=...)`` reuses them so planning + execution is
        bit-identical — same masks, flip-stream consumption, and call
        counts — to a single ``run(expr)``.  Pass ``pilot_stats`` to reuse
        an earlier ``pilot()`` probe (same seed/pilot_size) and only redo
        the host-side ordering.
        """
        self._check_names(expr)
        if self.optimize and needs_ordering(expr):
            if pilot_stats is None:
                tr = get_tracer()
                with tr.span("pilot", kind="plan",
                             pilot_size=self.pilot_size) as sp:
                    pilot_stats = self.pilot(expr)
                    n_pilot = sum(s.pilot_calls for s in pilot_stats.values())
                    sp.set(calls=n_pilot)
                    tr.metrics.inc("oracle.calls", n_pilot)
                    tr.metrics.inc("oracle.input_tokens", sum(
                        s.pilot_input_tokens for s in pilot_stats.values()))
                    tr.metrics.inc("oracle.output_tokens", sum(
                        s.pilot_output_tokens for s in pilot_stats.values()))
            estimate = optimize(expr, self.n, pilot_stats, self.cfg)
            return PreparedPlan(physical=estimate.ordered, estimate=estimate,
                                pilot_stats=pilot_stats)
        return PreparedPlan(physical=expr, estimate=None, pilot_stats={})

    def run(self, expr: Expr,
            prepared: Optional[PreparedPlan] = None) -> PlanResult:
        t0 = monotonic()
        if prepared is None:
            prepared = self.prepare(expr)
        else:
            self._check_names(expr)
        self._node_log: list = []
        self._results: Dict[str, FilterResult] = {}
        self._order: list = []

        estimate = prepared.estimate
        pilot_stats = prepared.pilot_stats
        physical = prepared.physical

        mask = self._eval(physical, np.arange(self.n))

        pilot_calls = sum(s.pilot_calls for s in pilot_stats.values())
        calls = pilot_calls + sum(r.n_llm_calls for r in self._node_log)
        in_tok = (sum(s.pilot_input_tokens for s in pilot_stats.values())
                  + sum(r.input_tokens for r in self._node_log))
        out_tok = (sum(s.pilot_output_tokens for s in pilot_stats.values())
                   + sum(r.output_tokens for r in self._node_log))
        return PlanResult(
            mask=mask, n_llm_calls=calls, pilot_calls=pilot_calls,
            input_tokens=in_tok, output_tokens=out_tok,
            order=list(self._order),
            naive_order=[p.name for p in expr.leaves()],
            node_log=self._node_log, results=self._results,
            estimate=estimate, pilot_stats=pilot_stats,
            total_time_s=monotonic() - t0)

    @staticmethod
    def _check_names(expr: Expr) -> None:
        """Leaf names key the pilot table and per-node results: one name
        bound to two different oracles would silently cost/order the second
        with the first's statistics."""
        seen: Dict[str, int] = {}
        for leaf in expr.leaves():
            prev = seen.setdefault(leaf.name, id(leaf.oracle))
            if prev != id(leaf.oracle):
                raise ValueError(
                    f"predicate name {leaf.name!r} is bound to two different "
                    "oracles; give each predicate a unique name")

    # ---------------------------------------------------------- evaluation
    def _where(self) -> dict:
        """The table's device and k-means seeder, for each driver run."""
        return dict(device=self.table.device,
                    init_centroids=self.table.init_centroids)

    def _eval(self, node: Expr, live: np.ndarray) -> np.ndarray:
        """Returns a full-length bool mask, meaningful at ``live`` positions."""
        if isinstance(node, Pred):
            return self._eval_pred(node, live)
        if isinstance(node, Not):
            child = self._eval(node.child, live)
            out = np.zeros(self.n, dtype=bool)
            out[live] = ~child[live]
            return out
        if isinstance(node, And):
            cur = live
            for c in node.children:
                if len(cur) == 0:
                    break
                m = self._eval(c, cur)
                cur = cur[m[cur]]  # short-circuit: only passers continue
            out = np.zeros(self.n, dtype=bool)
            out[cur] = True
            return out
        assert isinstance(node, Or)
        out = np.zeros(self.n, dtype=bool)
        rem = live
        for c in node.children:
            if len(rem) == 0:
                break
            m = self._eval(c, rem)
            out[rem[m[rem]]] = True
            rem = rem[~m[rem]]  # accepted tuples never re-evaluated
        return out

    def _eval_pred(self, leaf: Pred, live: np.ndarray) -> np.ndarray:
        if len(live) == 0:
            return np.zeros(self.n, dtype=bool)
        cfg = leaf.cfg if leaf.cfg is not None else self.cfg
        hit = self.memo.lookup(leaf, cfg) if self.memo is not None else None
        if hit is not None:
            return self._replay_pred(leaf, cfg, live, hit)
        tr = get_tracer()
        with tr.span("plan_node", kind="plan_node", node=leaf.name,
                     n_in=int(len(live))) as sp:
            assign = (self.table.precluster(cfg.n_clusters, cfg.seed)
                      if self.reuse_clustering else None)
            subset = None if len(live) == self.n else live
            fr = semantic_filter(self.table.embeddings, leaf.oracle, cfg,
                                 precomputed_assign=assign,
                                 subset_ids=subset, **self._where())
            sp.set(n_out=int(fr.mask.sum()), calls=int(fr.n_llm_calls))
        if self.memo is not None:
            self.memo.record(leaf, cfg, fr, live)
        self._log_node(leaf, live, fr)
        return fr.mask

    def _replay_pred(self, leaf: Pred, cfg: CSVConfig, live: np.ndarray,
                     hit) -> np.ndarray:
        """Serve a leaf from session-memoized decisions: clean-cluster rows
        replay the stored mask at zero oracle cost; rows of clusters dirtied
        by ``append``/``update`` since the memo's table version are re-voted
        through the normal driver, restricted to that dirty subset."""
        tr = get_tracer()
        t0 = monotonic()
        with tr.span("plan_node", kind="plan_node", node=leaf.name,
                     n_in=int(len(live)), replay=True) as sp:
            out = np.zeros(self.n, dtype=bool)
            replay = live[np.isin(live, hit.replay_rows)]
            out[replay] = hit.mask[replay]
            sub = None
            rerun = live[np.isin(live, hit.rerun_rows)]
            if len(rerun):
                assign = (self.table.precluster(cfg.n_clusters, cfg.seed)
                          if self.reuse_clustering else None)
                sub = semantic_filter(self.table.embeddings, leaf.oracle,
                                      cfg, precomputed_assign=assign,
                                      subset_ids=rerun, **self._where())
                out[rerun] = sub.mask[rerun]
            sp.set(n_out=int(out.sum()), n_replayed=int(len(replay)))
            tr.metrics.inc("memo.replays")
            tr.metrics.inc("memo.replayed_rows", int(len(replay)))
            tr.metrics.inc("memo.dirty_clusters",
                           int(getattr(hit, "n_dirty_clusters", 0)))
        fr = replay_result(out, n_input=len(live), n_replayed=len(replay),
                           rerun=sub, total_time_s=monotonic() - t0)
        if self.memo is not None:
            self.memo.record(leaf, cfg, fr, live)
        self._log_node(leaf, live, fr)
        return out

    def _log_node(self, leaf: Pred, live: np.ndarray,
                  fr: FilterResult) -> None:
        self._order.append(leaf.name)
        self._results[leaf.name] = fr
        self._node_log.append(NodeRecord(
            name=leaf.name, n_in=int(len(live)),
            n_out=int(fr.mask.sum()), n_llm_calls=fr.n_llm_calls,
            input_tokens=fr.input_tokens, output_tokens=fr.output_tokens,
            result=fr, n_replayed=int(fr.n_replayed)))
