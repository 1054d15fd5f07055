"""Semantic query plans: composable predicate DAGs over CSV filters.

Public API:
    Pred / And / Or / Not            — expression AST (&, |, ~ operators)
    PlanExecutor / PlanResult        — cost-ordered short-circuit cascades
    optimize / PlanEstimate          — logical -> physical lowering
    pilot_predicates / est_oracle_calls — the cost model
    sem_join / JoinConfig / JoinResult / pair_ids — CSV-backed semantic join

Entry points: ``Session.table(...).filter(expr)`` and ``.join(right,
oracle)`` (``repro_torch.api``).
"""
from repro_torch.plan.expr import And, Expr, Not, Or, Pred, needs_ordering
from repro_torch.plan.cost import PredStats, est_oracle_calls, pilot_predicates
from repro_torch.plan.optimizer import (NodeEstimate, PlanEstimate, node_estimates,
                                        optimize)
from repro_torch.plan.executor import (NodeRecord, PlanExecutor, PlanResult,
                                       PreparedPlan)
from repro_torch.plan.join import (JoinBlock, JoinConfig, JoinResult, JoinRound,
                                   pair_ids, sem_join)

__all__ = [
    "And", "Expr", "Not", "Or", "Pred", "needs_ordering",
    "PredStats", "est_oracle_calls", "pilot_predicates",
    "NodeEstimate", "PlanEstimate", "node_estimates", "optimize",
    "NodeRecord", "PlanExecutor", "PlanResult", "PreparedPlan",
    "JoinBlock", "JoinConfig", "JoinResult", "JoinRound",
    "pair_ids", "sem_join",
]
