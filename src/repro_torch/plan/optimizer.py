"""Logical -> physical lowering: cost-based reordering of And/Or children.

Given pilot statistics for every leaf (``repro_torch.plan.cost``), the optimizer
rewrites each And/Or node so its children run cheapest-first *in expectation*:
small fan-ins (the common case) are solved exactly by enumerating all
permutations of the expected-cascade-cost objective; larger fan-ins fall back
to the classic rank heuristic ``cost / (1 - selectivity)`` (AND) resp.
``cost / selectivity`` (OR), which is optimal for independent linear-cost
predicates and a good seed order otherwise.

The objective is expected *token* cost (calls weighted by each predicate's
pilot-measured tokens per call), with expected calls as tie-break — for
uniform-token oracles the two coincide.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional

from repro_torch.core.csv_filter import CSVConfig
from repro_torch.plan.cost import PredStats, est_oracle_calls
from repro_torch.plan.expr import And, Expr, Not, Pred, _Nary

# exact ordering up to this fan-in (6! = 720 cheap host-side evaluations);
# beyond it the rank heuristic keeps planning O(k log k)
MAX_EXHAUSTIVE = 6


@dataclasses.dataclass
class PlanEstimate:
    """Optimizer output: the reordered tree plus its predicted economics."""
    ordered: Expr
    order: list              # leaf names, physical (chosen) order
    naive_order: list        # leaf names, left-to-right logical order
    est_tokens_ordered: float
    est_tokens_naive: float
    est_calls_ordered: float
    est_calls_naive: float


def _leaf_cfg(leaf: Pred, default_cfg: CSVConfig) -> CSVConfig:
    return leaf.cfg if leaf.cfg is not None else default_cfg


def selectivity(expr: Expr, stats: Dict[str, PredStats]) -> float:
    """Estimated P(expr holds) assuming child independence."""
    if isinstance(expr, Pred):
        return stats[expr.name].selectivity
    if isinstance(expr, Not):
        return 1.0 - selectivity(expr.child, stats)
    sels = [selectivity(c, stats) for c in expr.children]
    prod = 1.0
    if isinstance(expr, And):
        for s in sels:
            prod *= s
        return prod
    for s in sels:
        prod *= (1.0 - s)
    return 1.0 - prod


def expected_cost(expr: Expr, n: float, stats: Dict[str, PredStats],
                  default_cfg: CSVConfig) -> tuple[float, float]:
    """(expected tokens, expected calls) of evaluating ``expr`` on ``n`` live
    tuples with its children in their CURRENT order (short-circuit cascade)."""
    if isinstance(expr, Pred):
        st = stats[expr.name]
        if st.replayable:
            return 0.0, 0.0  # session memo replays decisions for free
        calls = est_oracle_calls(n, _leaf_cfg(expr, default_cfg))
        return calls * st.tokens_per_call, calls
    if isinstance(expr, Not):
        return expected_cost(expr.child, n, stats, default_cfg)
    conj = isinstance(expr, And)
    tok = calls = 0.0
    live = float(n)
    for c in expr.children:
        t, k = expected_cost(c, live, stats, default_cfg)
        tok += t
        calls += k
        s = selectivity(c, stats)
        live *= s if conj else (1.0 - s)
    return tok, calls


def _reorder_node(node: _Nary, n: float, stats, default_cfg) -> _Nary:
    """Pick the child order minimizing the expected cascade cost."""
    kids = list(node.children)
    if len(kids) <= 1:
        return node
    conj = isinstance(node, And)
    if len(kids) <= MAX_EXHAUSTIVE:
        best = None
        for perm in itertools.permutations(range(len(kids))):
            tok = calls = 0.0
            live = float(n)
            for i in perm:
                t, k = expected_cost(kids[i], live, stats, default_cfg)
                tok += t
                calls += k
                s = selectivity(kids[i], stats)
                live *= s if conj else (1.0 - s)
            key = (tok, calls, perm)  # perm tie-break: deterministic plans
            if best is None or key < best:
                best = key
        order = best[2]
    else:
        def rank(i: int) -> tuple:
            tok, _ = expected_cost(kids[i], n, stats, default_cfg)
            s = selectivity(kids[i], stats)
            drop = (1.0 - s) if conj else s  # fraction short-circuited away
            return (tok / max(drop, 1e-9), i)
        order = sorted(range(len(kids)), key=rank)
    return type(node)(*[kids[i] for i in order])


def _lower(expr: Expr, n: float, stats, default_cfg) -> Expr:
    """Recursively reorder every And/Or node (children first, at the entry
    live-set size — survivor sizes inside siblings are second-order)."""
    if isinstance(expr, Pred):
        return expr
    if isinstance(expr, Not):
        return Not(_lower(expr.child, n, stats, default_cfg))
    kids = [_lower(c, n, stats, default_cfg) for c in expr.children]
    return _reorder_node(type(expr)(*kids), n, stats, default_cfg)


@dataclasses.dataclass
class NodeEstimate:
    """Predicted economics of one leaf at its position in the cascade."""
    name: str
    est_live_in: float       # live tuples expected to reach this node
    est_calls: float         # est_oracle_calls at that live-set size
    selectivity: Optional[float]  # pilot estimate; None without a pilot


def node_estimates(expr: Expr, n: float, stats: Dict[str, PredStats],
                   default_cfg: CSVConfig) -> list:
    """Per-leaf cost predictions for ``expr`` in its CURRENT child order.

    The walk mirrors ``expected_cost``'s short-circuit survivor arithmetic;
    leaves without pilot statistics assume selectivity 0.5 for survivor
    propagation but report ``selectivity=None``.  Powers ``.explain()`` in
    ``repro_torch.api`` — pure arithmetic, zero oracle calls.
    """
    out: list = []

    def sel_of(node: Expr) -> float:
        if isinstance(node, Pred):
            st = stats.get(node.name)
            return st.selectivity if st is not None else 0.5
        if isinstance(node, Not):
            return 1.0 - sel_of(node.child)
        sels = [sel_of(c) for c in node.children]
        prod = 1.0
        if isinstance(node, And):
            for s in sels:
                prod *= s
            return prod
        for s in sels:
            prod *= (1.0 - s)
        return 1.0 - prod

    def walk(node: Expr, live: float) -> None:
        if isinstance(node, Pred):
            st = stats.get(node.name)
            est = (0.0 if st is not None and st.replayable
                   else est_oracle_calls(live, _leaf_cfg(node, default_cfg)))
            out.append(NodeEstimate(
                name=node.name, est_live_in=float(live), est_calls=est,
                selectivity=st.selectivity if st is not None else None))
            return
        if isinstance(node, Not):
            walk(node.child, live)
            return
        conj = isinstance(node, And)
        cur = float(live)
        for c in node.children:
            walk(c, cur)
            s = sel_of(c)
            cur *= s if conj else (1.0 - s)

    walk(expr, float(n))
    return out


def optimize(expr: Expr, n: int, stats: Dict[str, PredStats],
             default_cfg: Optional[CSVConfig] = None) -> PlanEstimate:
    """Lower a logical expression to its cost-ordered physical form."""
    default_cfg = default_cfg or CSVConfig()
    ordered = _lower(expr, float(n), stats, default_cfg)
    tok_o, calls_o = expected_cost(ordered, float(n), stats, default_cfg)
    tok_n, calls_n = expected_cost(expr, float(n), stats, default_cfg)
    return PlanEstimate(
        ordered=ordered,
        order=[p.name for p in ordered.leaves()],
        naive_order=[p.name for p in expr.leaves()],
        est_tokens_ordered=tok_o, est_tokens_naive=tok_n,
        est_calls_ordered=calls_o, est_calls_naive=calls_n)
