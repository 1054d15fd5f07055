"""Cost model for predicate ordering (pilot sampling + a CSV call estimate).

Two ingredients:

1. **Pilot statistics.**  Before ordering a multi-predicate plan, each unique
   leaf oracle is probed on one small shared id sample.  That yields a
   selectivity estimate ``s`` (fraction of live tuples passing) and a mean
   per-call token cost — the quantities the classic predicate-ordering rank
   needs.  Pilot calls hit the oracle memo, so ids re-drawn later by the CSV
   sampler are free; the executor still reports them (``pilot_calls``) and
   counts them against the optimized plan's total.

2. **A closed-form estimate of CSV oracle calls** on ``n`` live tuples:
   ``K`` clusters of ~``n/K`` tuples each pay
   ``max(min_sample, ceil(xi * n/K))`` first-round sampled calls, plus an
   n-proportional residual (``RESIDUAL_CALL_RATE``) for re-clustering
   rounds and the linear fallback, capped at ``n`` by memoization.  The
   model only needs to *rank* orders, not predict absolute counts.

Expected cascade cost of an order pi over conjuncts (short-circuit AND):

    cost(pi) = sum_i tokens_i * est_calls(n_i),   n_{i+1} = n_i * s_i

and for OR the survivors are the not-yet-accepted ``n_{i+1} = n_i (1-s_i)``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence

import numpy as np

from repro_torch.core.csv_filter import CSVConfig, _derive_xi
from repro_torch.plan.expr import Pred


@dataclasses.dataclass
class PredStats:
    """Pilot-estimated properties of one leaf predicate."""
    name: str
    selectivity: float       # P(pred holds | live tuple), clamped to (0, 1)
    tokens_per_call: float   # mean input+output tokens per oracle call
    n_pilot: int             # pilot ids probed
    pilot_calls: int         # actual LLM calls spent (memo hits excluded)
    pilot_input_tokens: int = 0
    pilot_output_tokens: int = 0
    # where the selectivity came from: "pilot" (fresh probe), "observed"
    # (a previous run's actual pass rate — session memo), or "memo"
    # (decisions fully replayable at the current table version)
    source: str = "pilot"
    # True when the session memo can replay this leaf's decisions without
    # oracle calls: the optimizer then costs the leaf at zero, which orders
    # it first (free live-set shrinkage for everything downstream)
    replayable: bool = False


def pilot_predicates(leaves: Sequence[Pred], live_ids: np.ndarray,
                     rng: np.random.Generator, pilot_size: int
                     ) -> Dict[str, PredStats]:
    """Probe every unique leaf on one shared pilot sample of the live set.

    A single shared sample (a) keeps pilot cost at ``pilot_size`` calls per
    predicate and (b) estimates all selectivities on the same tuples, which
    is what the cascade's conditional survivor counts actually see.
    Selectivities are clamped away from {0, 1}: a pilot that happens to be
    unanimous must not make downstream conjuncts look free.
    """
    n = len(live_ids)
    take = min(pilot_size, n)
    ids = (rng.choice(live_ids, size=take, replace=False) if take < n
           else np.asarray(live_ids))
    out: Dict[str, PredStats] = {}
    for leaf in leaves:
        if leaf.name in out:
            continue
        with leaf.oracle.scope() as sc:
            labels = leaf.oracle(ids)
        d = sc.delta
        tokens = ((d.input_tokens + d.output_tokens) / d.n_calls
                  if d.n_calls else 64.0)
        lo = 1.0 / (take + 1)
        sel = min(1.0 - lo, max(lo, float(np.mean(labels))))
        out[leaf.name] = PredStats(name=leaf.name, selectivity=sel,
                                   tokens_per_call=tokens, n_pilot=take,
                                   pilot_calls=d.n_calls,
                                   pilot_input_tokens=d.input_tokens,
                                   pilot_output_tokens=d.output_tokens)
    return out


# n-proportional residual calls (re-clustering rounds, undetermined-vote
# follow-ups, linear fallback) on top of the first-round closed form.  On
# the Fig. 4 synthetic cases actual calls land at base + (0.1..0.3) * n;
# the conservative end is enough to *rank* orders, which is all the
# optimizer needs — it also keeps the model strictly decreasing in n, so
# shrinking the live set is never modelled as free-but-worthless.
RESIDUAL_CALL_RATE = 0.1


def est_oracle_calls(n: float, cfg: CSVConfig,
                     residual: float = RESIDUAL_CALL_RATE) -> float:
    """Expected CSV oracle calls for one pass over ``n`` live tuples."""
    if n <= 0:
        return 0.0
    if n <= cfg.min_sample:
        return float(n)
    # the same xi the driver will actually run with (epsilon-derived when set)
    xi = _derive_xi(cfg, sigma2=0.25)
    per = n / cfg.n_clusters
    first_round = cfg.n_clusters * max(cfg.min_sample, math.ceil(xi * per))
    # memoization caps any predicate's spend at one call per live tuple
    return float(min(n, first_round + residual * n))
