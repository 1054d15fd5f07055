"""ExecutionPolicy: one dataclass for every physical-execution knob.

The legacy surface scattered its knobs across ``sem_filter``'s keyword
arguments (``method``, ``executor``, ``pipeline_depth``, ``proxy``, baseline
``**kw``), ``CSVConfig``, ``JoinConfig``, and ``PlanExecutor``'s constructor.
``ExecutionPolicy`` absorbs all of them into a single frozen value object
that the lazy query layer resolves at ``.collect()`` time:

    Session default  <  Query policy  <  collect(policy=...) override

Conversion is lossless in both directions: ``to_csv_config`` /
``to_join_config`` produce exactly the config the legacy machinery expects
(so results stay bit-identical), and ``from_csv_config`` /
``from_join_config`` lift a legacy config into a policy.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

from repro_torch.core.csv_filter import CSVConfig
from repro_torch.plan.join import JoinConfig

METHODS = ("csv", "csv-sim", "reference", "lotus", "bargain")
BASELINE_METHODS = ("reference", "lotus", "bargain")
EXECUTORS = ("round", "sequential")


class OracleBudgetError(RuntimeError):
    """Raised before execution when the estimated oracle spend of a query
    exceeds ``ExecutionPolicy.max_oracle_calls``.  The guard is closed-form
    (``repro_torch.plan.cost.est_oracle_calls``-style, worst-case live sets) so it
    never consumes oracle calls itself."""


@dataclasses.dataclass(frozen=True)
class ExecutionPolicy:
    """Declarative physical-execution choices for one query (or session).

    method: "csv" (UniVote CSV), "csv-sim" (SimVote CSV), or one of the
        linear baselines "reference" / "lotus" / "bargain" — all five route
        through the same ``Query.collect()``.
    executor / pipeline_depth: round-vectorized vs. sequential CSV driver,
        and the number of overlapped oracle waves per round.  The service
        scheduler generalizes the same depth to barrier ticks: each tick
        splits into up to ``pipeline_depth`` packed waves so engine prefill
        of wave k+1 overlaps host-side voting on wave k (docs/serving.md).
    epsilon: user error tolerance; when set, the sampling rate xi is derived
        via the paper's Thm 3.3/3.6 instead of taken from ``xi``.
    max_oracle_calls: advisory pre-flight budget; ``collect()`` raises
        ``OracleBudgetError`` when the closed-form estimate exceeds it.
    baseline: extra keyword arguments for the lotus/bargain baselines
        (``sample_size``, ``recall_target``, ``accuracy_target``, ...).
    """

    # ---- logical routing ----
    method: str = "csv"
    # ---- CSV driver (mirrors CSVConfig) ----
    executor: str = "round"
    pipeline_depth: int = 1
    # shards: split each round's sample/oracle/vote wave across N mesh
    # hosts (repro_torch.distributed.round); bit-identical to shards=1 — a
    # physical knob like executor/pipeline_depth, excluded from the memo
    # fingerprint (docs/distributed.md)
    shards: int = 1
    n_clusters: int = 4
    xi: float = 0.005
    epsilon: Optional[float] = None   # error tolerance; derives xi when set
    min_sample: int = 101
    lb: float = 0.15
    ub: Optional[float] = None
    max_recluster: int = 3
    vote: Optional[str] = None        # None -> derived from method
    theory_l: float = 0.9996
    sim_v: float = 2.0
    sim_bandwidth: Optional[float] = None
    kmeans_iters: int = 50
    seed: int = 0
    # ---- plan lowering (multi-predicate expressions) ----
    optimize: bool = True
    pilot_size: int = 32
    reuse_clustering: bool = True
    # ---- session-level reuse (docs/caching.md) ----
    # reuse_memo: replay memoized per-tuple decisions for a predicate the
    # session has already evaluated on this table (zero oracle calls on an
    # unchanged table; after append()/update() only dirty clusters re-vote).
    # reuse_stats: plan later queries with memoized pilot probes and
    # observed (post-run) selectivities instead of fresh pilot calls.
    # Both are pure reuse: with an empty memo, behavior is bit-identical
    # to a cold session.
    reuse_memo: bool = True
    reuse_stats: bool = True
    # ---- joins ----
    n_clusters_right: Optional[int] = None  # None -> n_clusters
    max_refine: int = 3
    # ---- baselines (lotus/bargain keyword arguments) ----
    baseline: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    # ---- budget ----
    max_oracle_calls: Optional[int] = None
    # ---- durability (the service's session log; docs/distributed.md) ----
    # log_dir: when set, FilterService(policy=...) opens an append-only
    # session log there instead of whole-session snapshots; restart =
    # snapshot + log-tail replay.  Compaction triggers when either
    # threshold is crossed (checked at quiescent points).
    log_dir: Optional[str] = None
    log_compact_bytes: int = 4 << 20
    log_compact_records: int = 10_000
    # ---- online quality auditing (repro_torch.obs.audit) ----
    # audit_rate: fraction of the table held out as a stratified, seeded
    # audit sample after each collect(); the sample is labeled by the real
    # oracle and compared against the CSV-voted mask.  Audit spend is
    # accounted under ``audit.*`` metrics only — never ``oracle.*``, memo
    # state, or the oracle's RNG stream — so the default 0.0 is bit-identical
    # and auditing never perturbs the query it measures.  Excluded from
    # to_csv_config()/the memo fingerprint (a pure observation knob).
    audit_rate: float = 0.0
    audit_seed: int = 0
    audit_max_rows: int = 256
    # audit_error_bound: tolerated disagreement rate before a cluster is
    # flagged for re-vote/re-cluster; None derives epsilon (if set) else 0.05.
    audit_error_bound: Optional[float] = None

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(f"unknown method {self.method!r}; "
                             f"expected one of {METHODS}")
        if self.executor not in EXECUTORS:
            raise ValueError(f"unknown executor {self.executor!r}; "
                             f"expected one of {EXECUTORS}")
        if self.pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        if self.shards < 1:
            raise ValueError("shards must be >= 1")
        if self.shards > 1 and self.executor != "round":
            raise ValueError("shards > 1 requires executor='round'")
        if self.log_compact_bytes < 1 or self.log_compact_records < 1:
            raise ValueError("log compaction thresholds must be >= 1")
        if self.vote not in (None, "uni", "sim"):
            raise ValueError(f"unknown vote {self.vote!r}; "
                             "expected 'uni' or 'sim'")
        if not 0.0 <= self.audit_rate <= 1.0:
            raise ValueError("audit_rate must be in [0, 1]")
        if self.audit_max_rows < 1:
            raise ValueError("audit_max_rows must be >= 1")
        if self.audit_error_bound is not None and not (
                0.0 < self.audit_error_bound < 1.0):
            raise ValueError("audit_error_bound must be in (0, 1)")

    # ------------------------------------------------------------ derived
    @property
    def vote_(self) -> str:
        """Effective voting algorithm: csv-sim forces SimVote (matching the
        legacy ``sem_filter`` dispatch); otherwise the explicit ``vote``."""
        if self.method == "csv-sim":
            return "sim"
        return self.vote if self.vote is not None else "uni"

    @property
    def is_baseline(self) -> bool:
        return self.method in BASELINE_METHODS

    # -------------------------------------------------------- conversions
    def to_csv_config(self) -> CSVConfig:
        return CSVConfig(
            n_clusters=self.n_clusters, xi=self.xi,
            min_sample=self.min_sample, lb=self.lb, ub=self.ub,
            max_recluster=self.max_recluster, vote=self.vote_,
            epsilon=self.epsilon, theory_l=self.theory_l, sim_v=self.sim_v,
            sim_bandwidth=self.sim_bandwidth, kmeans_iters=self.kmeans_iters,
            seed=self.seed, executor=self.executor,
            pipeline_depth=self.pipeline_depth, shards=self.shards)

    def to_join_config(self) -> JoinConfig:
        right = (self.n_clusters_right if self.n_clusters_right is not None
                 else self.n_clusters)
        return JoinConfig(
            n_clusters_left=self.n_clusters, n_clusters_right=right,
            xi=self.xi, min_sample=self.min_sample, lb=self.lb, ub=self.ub,
            max_refine=self.max_refine, vote=self.vote_,
            sim_bandwidth=self.sim_bandwidth, kmeans_iters=self.kmeans_iters,
            seed=self.seed)

    @classmethod
    def from_csv_config(cls, cfg: CSVConfig, **overrides) -> "ExecutionPolicy":
        fields = dict(
            n_clusters=cfg.n_clusters, xi=cfg.xi, min_sample=cfg.min_sample,
            lb=cfg.lb, ub=cfg.ub, max_recluster=cfg.max_recluster,
            vote=cfg.vote, epsilon=cfg.epsilon, theory_l=cfg.theory_l,
            sim_v=cfg.sim_v, sim_bandwidth=cfg.sim_bandwidth,
            kmeans_iters=cfg.kmeans_iters, seed=cfg.seed,
            executor=cfg.executor, pipeline_depth=cfg.pipeline_depth,
            shards=cfg.shards)
        fields.update(overrides)
        return cls(**fields)

    @classmethod
    def from_join_config(cls, cfg: JoinConfig, **overrides) -> "ExecutionPolicy":
        fields = dict(
            n_clusters=cfg.n_clusters_left,
            n_clusters_right=cfg.n_clusters_right, xi=cfg.xi,
            min_sample=cfg.min_sample, lb=cfg.lb, ub=cfg.ub,
            max_refine=cfg.max_refine, vote=cfg.vote,
            sim_bandwidth=cfg.sim_bandwidth, kmeans_iters=cfg.kmeans_iters,
            seed=cfg.seed)
        fields.update(overrides)
        return cls(**fields)

    def replace(self, **changes) -> "ExecutionPolicy":
        return dataclasses.replace(self, **changes)
