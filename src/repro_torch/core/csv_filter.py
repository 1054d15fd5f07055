"""Algorithm 1: SemanticFilter(T, e, M, k, xi) — the CSV driver.

Host-side orchestration (cluster queue, recursive re-clustering, fallback)
around device-side batched math (k-means assignment, voting kernels) and
batched oracle invocations.  The driver is *restartable*: its state is the
oracle memo plus the deterministic RNG seed, so a preempted run resumes by
replaying decisions against cached LLM calls (no re-invocation).

Two executors share the same decision semantics (bit-identical masks and
call counts under a fixed seed — see tests/test_torch_csv_filter.py):

- ``executor="round"`` (default): a round-vectorized pipeline
  plan → sample → oracle → vote → partition.  Within each re-clustering
  round the sample ids of ALL live clusters are gathered into a single
  cross-cluster oracle call (one large prompt batch that actually fills the
  serving engine's buckets) and voting for all clusters runs in one
  segmented device dispatch.  ``pipeline_depth > 1`` splits a round into
  that many waves and submits wave k+1's oracle batch (async, strict FIFO)
  before voting wave k — oracle prefill overlaps device voting.
- ``executor="sequential"``: the original one-cluster-at-a-time loop, kept
  as the regression baseline.

Bit-identity argument: the planner draws each cluster's sample with the same
``rng.choice`` in the same cluster order as the sequential loop (the driver
RNG and the oracle's flip RNG are separate streams), and a numpy Generator
produces the same values whether drawn as one batch or consecutively —
so the concatenated oracle batch consumes the flip stream exactly as C
per-cluster calls would.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import theory
from repro_torch.core.clustering import Seeder, kmeans
from repro_torch.core.oracle import (AsyncOracleDispatcher,
                                     SyncOracleDispatcher)
from repro_torch.core.voting import sim_vote, uni_vote, vote_clusters
from repro_torch.distributed.round import shard_clusters
from repro_torch.obs.trace import get_tracer
from repro_torch.utils.device import resolve_device
from repro_torch.utils.timing import monotonic


@dataclasses.dataclass
class CSVConfig:
    n_clusters: int = 4
    xi: float = 0.005
    min_sample: int = 101
    lb: float = 0.15
    ub: Optional[float] = None  # default 1 - lb
    max_recluster: int = 3
    vote: str = "uni"  # "uni" | "sim"
    epsilon: Optional[float] = None  # if set, xi is derived from Thm 3.3/3.6
    theory_l: float = 0.9996
    sim_v: float = 2.0
    sim_bandwidth: Optional[float] = None
    kmeans_iters: int = 50
    seed: int = 0
    executor: str = "round"  # "round" | "sequential"
    pipeline_depth: int = 1  # oracle waves per round (>1 overlaps prefill
    #                          of the next wave with voting of the current)
    shards: int = 1  # >1 partitions each round's clusters across shards
    #                  (repro_torch.distributed.round) — bit-identical masks,
    #                  call counts, and memo state to shards=1

    @property
    def ub_(self) -> float:
        return self.ub if self.ub is not None else 1.0 - self.lb


@dataclasses.dataclass
class FilterResult:
    mask: np.ndarray  # (N,) bool — tuples passing the filter
    n_llm_calls: int
    input_tokens: int  # delta for THIS run (oracle may be shared/reused)
    output_tokens: int
    n_voted: int  # tuples decided by voting (no LLM call)
    n_fallback: int  # tuples decided by the final linear fallback
    recluster_rounds: int
    recluster_time_s: float
    total_time_s: float
    cluster_log: list  # per-cluster (size, sample, score stats) records
    xi_used: float
    round_log: list = dataclasses.field(default_factory=list)
    oracle_batch_sizes: list = dataclasses.field(default_factory=list)
    # tuples the driver was asked to decide: the full table, or the live
    # subset when a plan cascade masks out already-rejected tuples
    n_input: int = -1
    # tuples decided by replaying a session-memoized earlier run (zero
    # oracle cost); > 0 only on the repro_torch.api reuse path
    n_replayed: int = 0


def replay_result(mask: np.ndarray, n_input: int, n_replayed: int,
                  rerun: Optional[FilterResult] = None,
                  total_time_s: float = 0.0) -> FilterResult:
    """FilterResult for a (possibly partial) memo replay.

    ``mask`` is the merged full-length decision mask; ``rerun`` is the
    driver result for the dirty subset that had to be re-voted (None when
    the whole live set replayed).  Replayed tuples cost zero oracle calls,
    so every count not covered by ``rerun`` is zero.
    """
    if rerun is None:
        return FilterResult(
            mask=mask, n_llm_calls=0, input_tokens=0, output_tokens=0,
            n_voted=0, n_fallback=0, recluster_rounds=0,
            recluster_time_s=0.0, total_time_s=total_time_s, cluster_log=[],
            xi_used=0.0, n_input=int(n_input), n_replayed=int(n_replayed))
    return dataclasses.replace(
        rerun, mask=mask, n_input=int(n_input), n_replayed=int(n_replayed),
        total_time_s=total_time_s or rerun.total_time_s)


# ---------------------------------------------------------------- round plan
@dataclasses.dataclass
class ClusterPlan:
    ids: np.ndarray         # global tuple ids of the cluster
    sample_ids: np.ndarray  # ids submitted to the oracle
    rest_ids: np.ndarray    # ids decided by voting
    size: int
    n_sample: int


@dataclasses.dataclass
class RoundPlan:
    depth: int
    clusters: list

    @property
    def n_sampled(self) -> int:
        return int(sum(c.n_sample for c in self.clusters))


@dataclasses.dataclass
class RoundResult:
    depth: int
    n_clusters: int
    n_sampled: int
    n_voted: int
    n_undetermined: int
    waves: int
    oracle_batches: list  # submitted batch size per wave
    shards: int = 1  # shards that executed this round (1 = single-host)


def plan_round(queue: list, rng: np.random.Generator, xi: float,
               cfg: CSVConfig, depth: int) -> RoundPlan:
    """Draw every cluster's sample (same RNG order as the sequential loop)."""
    clusters = []
    for cluster in queue:
        m = len(cluster)
        n_sample = theory.choose_sample_size(m, xi, cfg.min_sample)
        sample_local = rng.choice(m, size=n_sample, replace=False)
        rest_mask = np.ones(m, dtype=bool)
        rest_mask[sample_local] = False
        clusters.append(ClusterPlan(
            ids=cluster, sample_ids=cluster[sample_local],
            rest_ids=cluster[rest_mask], size=m, n_sample=n_sample))
    return RoundPlan(depth=depth, clusters=clusters)


def _observe_vote_margin(score: float, lb: float, ub: float) -> None:
    """Export how close a cluster's vote score sat to its decision band.

    A collapsing margin (scores hugging lb/ub) means votes are barely
    decided — the health monitor alerts on the distribution
    (``quality.vote_margin``).  Observation-only: the ambient registry is a
    no-op ``NullRegistry`` unless a tracer is installed.
    """
    get_tracer().metrics.observe("quality.vote_margin",
                                 min(abs(score - lb), abs(ub - score)))


def _vote_wave(wave: list, labels_by_cluster: list, emb: np.ndarray,
               cfg: CSVConfig, lb: float, ub: float, device):
    """One segmented voting dispatch for every non-exhausted wave cluster."""
    live = [i for i, cp in enumerate(wave) if len(cp.rest_ids)]
    if not live:
        return {}
    sim = cfg.vote == "sim"
    votes = vote_clusters(
        cfg.vote, [labels_by_cluster[i] for i in live],
        [len(wave[i].rest_ids) for i in live], lb, ub,
        emb_unsampled=[emb[wave[i].rest_ids] for i in live] if sim else None,
        emb_sampled=[emb[wave[i].sample_ids] for i in live] if sim else None,
        bandwidth=cfg.sim_bandwidth, device=device)
    return dict(zip(live, votes))


def _recluster_or_fallback(emb, oracle, cfg, pending, depth, result, decided,
                           device, init_centroids):
    """Shared round tail: route undetermined tuples to the linear fallback
    or a k-means re-split.  Both executors MUST share this — the
    bit-identity contract depends on identical key/fallback derivation.
    Returns (next_queue, n_fallback_added, recluster_seconds)."""
    tr = get_tracer()
    with tr.span("partition", kind="partition", depth=depth,
                 n_pending=int(len(pending))) as sp:
        if depth > cfg.max_recluster:
            # final fallback: direct LLM evaluation (bounded error by design)
            labels = oracle(pending)
            result[pending] = labels
            decided[pending] = True
            sp.set(outcome="fallback")
            return [], len(pending), 0.0
        t_rc = monotonic()
        k = min(cfg.n_clusters, len(pending))
        if len(pending) <= cfg.min_sample:
            labels = oracle(pending)
            result[pending] = labels
            decided[pending] = True
            sp.set(outcome="small_fallback")
            return [], len(pending), monotonic() - t_rc
        # the seed the reference passes to jax.random.key
        _, sub_assign, _ = kmeans(cfg.seed + depth, emb[pending], k,
                                  max_iters=cfg.kmeans_iters,
                                  init_centroids=init_centroids,
                                  device=device)
        sub_assign = sub_assign.cpu().numpy()
        queue = [pending[sub_assign == c] for c in range(k)]
        queue = [c for c in queue if len(c)]
        sp.set(outcome="recluster", n_children=len(queue))
        return queue, 0, monotonic() - t_rc


def _merge_wave(wave: list, labels_by_cluster: list, votes: dict,
                depth: int, result, decided, cluster_log: list,
                undetermined: list, lb: float, ub: float,
                observe_margin: bool) -> int:
    """Write one wave's sample labels and vote outcomes back in cluster
    order, log each cluster and collect its undetermined rows; returns the
    rows voted.  ``observe_margin`` feeds ``quality.vote_margin``, which
    the reference observes in unsharded rounds only."""
    voted_total = 0
    for i, cp in enumerate(wave):
        labels = labels_by_cluster[i]
        result[cp.sample_ids] = labels
        decided[cp.sample_ids] = True
        if len(cp.rest_ids) == 0:
            cluster_log.append({
                "size": cp.size, "sampled": cp.n_sample,
                "score": float(np.mean(labels)),
                "depth": depth, "outcome": "exhausted"})
            continue
        vr = votes[i]
        result[cp.rest_ids[vr.decided_true]] = True
        decided[cp.rest_ids[vr.decided_true]] = True
        result[cp.rest_ids[vr.decided_false]] = False
        decided[cp.rest_ids[vr.decided_false]] = True
        voted = len(vr.decided_true) + len(vr.decided_false)
        voted_total += voted
        if len(vr.undetermined):
            undetermined.append(cp.rest_ids[vr.undetermined])
        score = float(np.mean(labels))
        if observe_margin:
            _observe_vote_margin(score, lb, ub)
        cluster_log.append({
            "size": cp.size, "sampled": cp.n_sample,
            "score": score,
            "voted": int(voted),
            "undetermined": int(len(vr.undetermined)),
            "depth": depth,
            "outcome": ("vote" if not len(vr.undetermined)
                        else "recluster"),
        })
    return voted_total


def _run_round_executor(emb, oracle, cfg, rng, xi, result, decided,
                        cluster_log, round_log, queue, device,
                        init_centroids):
    """plan → sample → oracle → vote → partition, one round per iteration.

    With ``cfg.shards > 1`` a round's clusters are split into shards
    (``repro_torch.distributed.round.shard_clusters``: contiguous, balanced
    by sample count) instead of ``cfg.pipeline_depth`` even waves.  The
    shards share this process and card, so each is a wave: its oracle batch
    goes through the same FIFO lane in shard order, it votes on its own,
    and a ``gather`` step writes every shard's outputs back in round
    cluster order, which keeps masks, calls and logs equal to
    ``shards=1``.  Spans and metrics follow the reference's sharded path
    (``shard`` tags, the ``gather`` span, ``distributed.*`` metrics, no
    ``quality.vote_margin``).
    """
    tr = get_tracer()
    lb, ub = cfg.lb, cfg.ub_
    sharded = cfg.shards > 1
    tag = "shard" if sharded else "wave"
    n_voted = n_fallback = 0
    rounds_used = 0
    recluster_time = 0.0
    depth = 0
    while queue and depth <= cfg.max_recluster:
        extra = {"shards": int(cfg.shards)} if sharded else {}
        with tr.span("round", kind="round", depth=depth,
                     n_clusters=len(queue), executor="round",
                     **extra) as rsp:
            t_round = monotonic()
            with tr.span("plan", kind="plan"):
                plan = plan_round(queue, rng, xi, cfg, depth)
            if sharded:
                waves = shard_clusters(plan.clusters, cfg.shards)
            else:
                n_waves = max(1, min(int(cfg.pipeline_depth),
                                     len(plan.clusters)))
                bounds = np.linspace(0, len(plan.clusters),
                                     n_waves + 1).astype(int)
                waves = [plan.clusters[bounds[k]:bounds[k + 1]]
                         for k in range(n_waves)]
                waves = [w for w in waves if w]

            dispatcher = (AsyncOracleDispatcher(oracle) if len(waves) > 1
                          else SyncOracleDispatcher(oracle))
            handles = []
            undetermined = []
            round_voted = 0
            oracle_batches = []
            outputs = []  # sharded: (shard, labels, votes) for the gather
            try:
                for k, wave in enumerate(waves):
                    shard_attrs = ({"n_clusters": len(wave)} if sharded
                                   else {})
                    with tr.span("oracle", kind="oracle", **{tag: k},
                                 **shard_attrs) as osp:
                        if k == 0:
                            # submitting wave 0 here (not before the loop)
                            # keeps submission order — submit(0), submit(1),
                            # result(0) — with submit+wait inside the span
                            handles.append(dispatcher.submit(
                                np.concatenate([cp.sample_ids
                                                for cp in waves[0]])))
                        if k + 1 < len(waves):
                            # overlap: next wave's oracle prefill starts
                            # before this wave's voting touches the device
                            handles.append(dispatcher.submit(
                                np.concatenate([cp.sample_ids
                                                for cp in waves[k + 1]])))
                        flat_labels = handles[k].result()
                        osp.set(batch=int(len(flat_labels)))
                    oracle_batches.append(int(len(flat_labels)))
                    offsets = np.cumsum([cp.n_sample for cp in wave])[:-1]
                    labels_by_cluster = np.split(flat_labels, offsets)

                    with tr.span("vote", kind="vote", **{tag: k},
                                 n_clusters=len(wave)):
                        votes = _vote_wave(wave, labels_by_cluster, emb,
                                           cfg, lb, ub, device)
                        if not sharded:
                            round_voted += _merge_wave(
                                wave, labels_by_cluster, votes, depth,
                                result, decided, cluster_log, undetermined,
                                lb, ub, observe_margin=True)
                    if sharded:
                        outputs.append((wave, labels_by_cluster, votes))
            finally:
                dispatcher.close()

            if sharded:
                # the all-gather point: every shard's sample labels and
                # vote outcomes merge in shard order (== round cluster
                # order) before the partition step sees any of them
                with tr.span("gather", kind="gather", depth=depth,
                             shards=len(outputs)):
                    for wave, labels_by_cluster, votes in outputs:
                        round_voted += _merge_wave(
                            wave, labels_by_cluster, votes, depth, result,
                            decided, cluster_log, undetermined, lb, ub,
                            observe_margin=False)
            n_voted += round_voted

            n_undet = int(sum(len(u) for u in undetermined))
            round_log.append(RoundResult(
                depth=depth, n_clusters=len(plan.clusters),
                n_sampled=plan.n_sampled, n_voted=round_voted,
                n_undetermined=n_undet, waves=len(waves),
                oracle_batches=oracle_batches,
                shards=len(waves) if sharded else 1))
            rsp.set(n_sampled=plan.n_sampled, n_voted=round_voted,
                    n_undetermined=n_undet, **{tag + "s": len(waves)})
            tr.metrics.inc("driver.rounds")
            if sharded:
                tr.metrics.inc("distributed.sharded_rounds")
                tr.metrics.observe("distributed.shards_per_round",
                                   len(waves))
            tr.metrics.observe("round.wall_s", monotonic() - t_round)

            if not undetermined:
                break
            pending = np.concatenate(undetermined)
            depth += 1
            rounds_used = depth
            queue, fb, dt = _recluster_or_fallback(
                emb, oracle, cfg, pending, depth, result, decided, device,
                init_centroids)
            n_fallback += fb
            recluster_time += dt
    return n_voted, n_fallback, rounds_used, recluster_time


def _run_sequential_executor(emb, oracle, cfg, rng, xi, result, decided,
                             cluster_log, round_log, queue, device,
                             init_centroids):
    """The pre-refactor cluster-at-a-time loop (regression baseline)."""
    tr = get_tracer()
    lb, ub = cfg.lb, cfg.ub_
    n_voted = n_fallback = 0
    rounds_used = 0
    recluster_time = 0.0
    depth = 0
    while queue and depth <= cfg.max_recluster:
        with tr.span("round", kind="round", depth=depth,
                     n_clusters=len(queue), executor="sequential"):
            undetermined = []
            for cluster in queue:
                m = len(cluster)
                n_sample = theory.choose_sample_size(m, xi, cfg.min_sample)
                sample_local = rng.choice(m, size=n_sample, replace=False)
                sample_ids = cluster[sample_local]
                labels = oracle(sample_ids)
                result[sample_ids] = labels
                decided[sample_ids] = True

                rest_mask = np.ones(m, dtype=bool)
                rest_mask[sample_local] = False
                rest_ids = cluster[rest_mask]
                if len(rest_ids) == 0:
                    cluster_log.append({
                        "size": m, "sampled": n_sample,
                        "score": float(np.mean(labels)),
                        "depth": depth, "outcome": "exhausted"})
                    continue

                if cfg.vote == "sim":
                    vr = sim_vote(emb[rest_ids], emb[sample_ids],
                                  labels.astype(np.float32), lb, ub,
                                  cfg.sim_bandwidth, device=device)
                else:
                    vr = uni_vote(labels.astype(np.float32), len(rest_ids),
                                  lb, ub)

                result[rest_ids[vr.decided_true]] = True
                decided[rest_ids[vr.decided_true]] = True
                result[rest_ids[vr.decided_false]] = False
                decided[rest_ids[vr.decided_false]] = True
                n_voted += len(vr.decided_true) + len(vr.decided_false)
                if len(vr.undetermined):
                    undetermined.append(rest_ids[vr.undetermined])
                score = float(np.mean(labels))
                _observe_vote_margin(score, lb, ub)
                cluster_log.append({
                    "size": m, "sampled": n_sample,
                    "score": score,
                    "voted": int(len(vr.decided_true)
                                 + len(vr.decided_false)),
                    "undetermined": int(len(vr.undetermined)),
                    "depth": depth,
                    "outcome": ("vote" if not len(vr.undetermined)
                                else "recluster"),
                })

            if not undetermined:
                break
            pending = np.concatenate(undetermined)
            depth += 1
            rounds_used = depth
            queue, fb, dt = _recluster_or_fallback(
                emb, oracle, cfg, pending, depth, result, decided, device,
                init_centroids)
            n_fallback += fb
            recluster_time += dt
    return n_voted, n_fallback, rounds_used, recluster_time


def _derive_xi(cfg: CSVConfig, sigma2: float) -> float:
    if cfg.epsilon is None:
        return cfg.xi
    if cfg.vote == "sim":
        return theory.xi_for_epsilon_simvote(cfg.epsilon, sigma2, cfg.theory_l,
                                             cfg.sim_v)
    return theory.xi_for_epsilon_univote(cfg.epsilon, sigma2, cfg.theory_l)


def semantic_filter(embeddings: np.ndarray, oracle, cfg: CSVConfig = None,
                    precomputed_assign: Optional[np.ndarray] = None,
                    subset_ids: Optional[np.ndarray] = None, *,
                    init_centroids: Optional[Seeder] = None,
                    device="cuda") -> FilterResult:
    """Run CSV over a table represented by its tuple embeddings.

    embeddings: (N, D) — generated offline (paper phase 1).
    oracle: callable(ids)->bool array with .stats (see repro_torch.core.oracle).
    subset_ids: restrict the filter to these tuple ids (plan-cascade entry
    point: conjuncts after the first only see tuples still alive).  The
    returned mask stays full-length with False outside the subset; a
    full-table ``precomputed_assign`` is restricted to the subset, so the
    offline clustering is reused rather than recomputed per conjunct.
    init_centroids: k-means seeder hook ``(seed, x, k) -> (k, D)``; it gets
    ``cfg.seed`` for the pre-clustering and ``cfg.seed + depth`` for each
    re-cluster (default: ``repro_torch.core.clustering.plusplus_init``).
    device: where k-means and SimVote run; ``"cuda"`` unless the caller
    asks for ``"cpu"``.
    """
    device = resolve_device(device)
    cfg = cfg or CSVConfig()
    if cfg.executor not in ("round", "sequential"):
        raise ValueError(f"unknown executor {cfg.executor!r}; "
                         "expected 'round' or 'sequential'")
    if cfg.shards < 1:
        raise ValueError(f"shards must be >= 1, got {cfg.shards}")
    if cfg.shards > 1 and cfg.executor != "round":
        raise ValueError("shards > 1 requires executor='round'")
    t0 = monotonic()
    rng = np.random.default_rng(cfg.seed)
    n = embeddings.shape[0]
    emb = np.asarray(embeddings, dtype=np.float32)
    result = np.zeros(n, dtype=bool)
    decided = np.zeros(n, dtype=bool)
    stats_before = oracle.stats.clone()
    xi = _derive_xi(cfg, sigma2=0.25)  # worst-case sigma before seeing data
    cluster_log: list = []
    round_log: list = []
    subset = (None if subset_ids is None
              else np.unique(np.asarray(subset_ids, dtype=np.int64)))

    # ---- initial clustering (offline phase; query-agnostic) ----
    if subset is not None and len(subset) == 0:
        queue = []
    elif precomputed_assign is not None:
        assign = np.asarray(precomputed_assign)
        if subset is not None:
            sub_assign = assign[subset]
            queue = [subset[sub_assign == c]
                     for c in range(int(sub_assign.max()) + 1)]
        else:
            queue = [np.nonzero(assign == c)[0]
                     for c in range(int(assign.max()) + 1)]
        queue = [c for c in queue if len(c)]
    else:
        rows = subset if subset is not None else np.arange(n)
        k = min(cfg.n_clusters, len(rows))
        _, assign, _ = kmeans(cfg.seed, emb[rows], k,
                              max_iters=cfg.kmeans_iters,
                              init_centroids=init_centroids, device=device)
        assign = assign.cpu().numpy()
        queue = [rows[assign == c] for c in range(int(assign.max()) + 1)]
        queue = [c for c in queue if len(c)]

    run = (_run_sequential_executor if cfg.executor == "sequential"
           else _run_round_executor)
    n_voted, n_fallback, rounds_used, recluster_time = run(
        emb, oracle, cfg, rng, xi, result, decided, cluster_log, round_log,
        queue, device, init_centroids)

    # survives python -O: this postcondition guards the paper's completeness
    # contract (every tuple decided), not a debug assumption
    undecided = (~decided if subset is None else ~decided[subset])
    if undecided.any():
        raise RuntimeError(
            f"driver left {int(undecided.sum())} tuple(s) undecided — "
            "executor invariant violated")
    delta = oracle.stats.delta(stats_before)
    metrics = get_tracer().metrics
    metrics.inc("oracle.calls", delta.n_calls)
    metrics.inc("oracle.input_tokens", delta.input_tokens)
    metrics.inc("oracle.output_tokens", delta.output_tokens)
    metrics.inc("driver.voted", n_voted)
    metrics.inc("driver.fallback", n_fallback)
    return FilterResult(
        mask=result,
        n_llm_calls=delta.n_calls,
        input_tokens=delta.input_tokens,
        output_tokens=delta.output_tokens,
        n_voted=n_voted,
        n_fallback=n_fallback,
        recluster_rounds=rounds_used,
        recluster_time_s=recluster_time,
        total_time_s=monotonic() - t0,
        cluster_log=cluster_log,
        xi_used=xi,
        round_log=round_log,
        oracle_batch_sizes=delta.batch_sizes,
        n_input=int(n if subset is None else len(subset)),
    )
