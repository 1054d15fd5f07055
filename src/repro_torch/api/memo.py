"""Cross-query session memo: decisions, pilot probes, observed selectivities.

CSV's sublinear oracle complexity is per-query; a session filtering the same
table repeatedly can do better by amortizing three things across queries
(the Larch-style multi-query optimization named in ROADMAP.md):

- **decisions** — a predicate evaluated over the full table leaves a
  complete per-tuple mask behind.  Re-running the same predicate (same
  oracle object, same semantic config) on an unchanged table *replays* that
  mask at zero oracle cost, bit-identically.  After ``append``/``update``
  only the clusters the mutation touched are re-voted; clean-cluster rows
  still replay.
- **pilot probes** — per-(predicate, table-version) pilot statistics are
  kept, so a later multi-predicate query re-plans without re-probing leaves
  it has already seen.
- **observed selectivities** — after a leaf actually runs, its real pass
  rate replaces the pilot estimate for every later query's cost ordering
  (observed beats a 32-sample probe).

Everything here is *reused observation*, never new spend: with an empty
memo the planner and executor behave bit-identically to a cold session
(asserted in tests/test_torch_api.py).  ``ExecutionPolicy.reuse_memo``
gates decision replay, ``reuse_stats`` gates pilot/selectivity reuse.

The memo keys predicates by ``(table name, id(oracle))`` and holds a strong
reference to every oracle it has seen, so CPython id reuse can never alias
two predicates.  Decision entries also carry a fingerprint of the
semantics-affecting ``CSVConfig`` fields: a different xi / vote / seed is a
different sampling process, so its decisions are not replayed (executor and
pipeline_depth are excluded — those are bit-identical by contract).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.core.csv_filter import CSVConfig, FilterResult
from repro_torch.plan.cost import PredStats
from repro_torch.plan.expr import Pred


def oracle_identity(oracle) -> Any:
    """The object whose ``id()`` keys memo entries.

    The service layer (``repro_torch.service.scheduler``) wraps leaf oracles in
    batching proxies; a proxy advertises the oracle it stands in for via
    ``memo_target`` so a scheduled and a serial collection of the same
    predicate land on ONE memo identity — decisions recorded by either
    replay for both."""
    return getattr(oracle, "memo_target", oracle)


def cfg_fingerprint(cfg: CSVConfig) -> tuple:
    """Semantics-affecting CSVConfig fields (mask-identity equivalence
    class).  executor / pipeline_depth are physical knobs with a guarded
    bit-identity contract, so replay is valid across them."""
    return (cfg.n_clusters, cfg.xi, cfg.min_sample, cfg.lb, cfg.ub,
            cfg.max_recluster, cfg.vote, cfg.epsilon, cfg.theory_l,
            cfg.sim_v, cfg.sim_bandwidth, cfg.kmeans_iters, cfg.seed)


def join_fingerprint(cfg) -> tuple:
    """Semantics-affecting JoinConfig fields: any change is a different
    sampling process, so its pair decisions are not replayed."""
    return (cfg.n_clusters_left, cfg.n_clusters_right, cfg.xi,
            cfg.min_sample, cfg.lb, cfg.ub, cfg.max_refine, cfg.vote,
            cfg.sim_bandwidth, cfg.kmeans_iters, cfg.seed)


@dataclasses.dataclass
class DecisionMemo:
    """One predicate's full-table decisions at one table version."""
    version: int                  # table version the mask was decided at
    n: int                        # table length at that version
    mask: np.ndarray              # (n,) bool — the decided mask
    cluster_key: Tuple[int, int]  # (n_clusters, seed) clustering used
    fingerprint: tuple            # cfg_fingerprint of the run


@dataclasses.dataclass
class SelObservation:
    """Latest observed pass rate (and token cost) of one predicate."""
    version: int
    selectivity: float
    tokens_per_call: float


@dataclasses.dataclass
class JoinDecisionMemo:
    """One join predicate's full pair-mask at one (left, right) version
    pair.  Pair ids reindex under ANY mutation of either side, so these
    entries are cleared outright (never patched) — the versions are stored
    only as a defensive replay gate."""
    left_version: int
    right_version: int
    pair_mask: np.ndarray        # (|L|, |R|) bool
    fingerprint: tuple           # join_fingerprint of the run


@dataclasses.dataclass
class ReplayHit:
    """Executor-facing replay plan for one leaf.

    ``replay_rows``/``rerun_rows`` partition the current table: replay rows
    take their decision from ``mask`` (zero oracle cost), rerun rows — the
    members of clusters dirtied since the memo's version, including every
    appended row — go back through the CSV driver."""
    mask: np.ndarray
    replay_rows: np.ndarray
    rerun_rows: np.ndarray
    n_dirty_clusters: int = 0    # clusters whose members rerun (metrics)

    @property
    def full(self) -> bool:
        return len(self.rerun_rows) == 0


class SessionMemo:
    """Session-owned store behind the reuse views (one per Session)."""

    def __init__(self):
        # durability hook: called as hook(kind, **fields) whenever an
        # entry worth persisting is stored — kinds "decision",
        # "selectivity", "pilot", "join" (a session log appends a
        # framed record per event; None costs nothing)
        self.hook = None
        self._decisions: Dict[tuple, DecisionMemo] = {}
        self._selectivity: Dict[tuple, SelObservation] = {}
        self._pilots: Dict[tuple, PredStats] = {}
        # join pair decisions keyed (left, right, oracle id, fingerprint) —
        # replayed whole, cleared whole (docs/caching.md invalidation rules)
        self._join_decisions: Dict[tuple, JoinDecisionMemo] = {}
        # strong refs ONLY for oracles with stored entries (decisions /
        # pilots / selectivities are keyed by id(), which must stay stable);
        # mere sightings are weak so a session that never stores anything —
        # reuse pinned off — doesn't retain every
        # oracle (and its labels + per-id memo) it ever saw
        self._oracles: Dict[int, Any] = {}
        self._sightings: Dict[str, Dict[int, Any]] = {}       # weak refs
        # join (pair-space) oracles per table: their memo keys are pair ids,
        # which reindex on mutation — they need full clears, not per-id drops
        self._pair_sightings: Dict[str, Dict[int, Any]] = {}  # weak refs

    # ----------------------------------------------------------- plumbing
    def _pred_key(self, table: str, oracle) -> tuple:
        """Key for STORING an entry: pins a strong oracle reference.

        Service-layer batching proxies resolve to the oracle they wrap
        (``oracle_identity``), so scheduled and serial collections share
        one identity."""
        oracle = oracle_identity(oracle)
        oid = id(oracle)
        self._oracles[oid] = oracle
        self.note_sighting(table, oracle)
        return (table, oid)

    @staticmethod
    def _note(store: Dict[str, Dict[int, Any]], table: str, oracle) -> None:
        try:
            ref = weakref.ref(oracle)
        except TypeError:           # unweakrefable oracle: keep it alive
            ref = (lambda o: (lambda: o))(oracle)
        store.setdefault(table, {})[id(oracle)] = ref

    @staticmethod
    def _live(store: Dict[str, Dict[int, Any]], table: str) -> list:
        refs = store.get(table, {})
        out = []
        for oid in list(refs):
            oracle = refs[oid]()
            if oracle is None:
                del refs[oid]       # collected: nothing left to invalidate
            else:
                out.append(oracle)
        return out

    def note_sighting(self, table: str, oracle) -> None:
        """Record that ``oracle`` answered tuple ids of ``table`` (weak)."""
        self._note(self._sightings, table, oracle_identity(oracle))

    def oracles_for(self, table: str) -> list:
        """Every live oracle this memo has seen touch ``table``
        (update-path per-id memo invalidation)."""
        return self._live(self._sightings, table)

    def note_pair_oracle(self, table: str, oracle) -> None:
        self._note(self._pair_sightings, table, oracle_identity(oracle))

    def pair_oracles_for(self, table: str) -> list:
        return self._live(self._pair_sightings, table)

    # -------------------------------------------------- join decisions
    def _join_key(self, left: str, right: str, oracle, cfg) -> tuple:
        oracle = oracle_identity(oracle)
        return (left, right, id(oracle), join_fingerprint(cfg))

    def lookup_join(self, left_handle, right_handle, oracle,
                    cfg) -> Optional[JoinDecisionMemo]:
        """Replayable pair decisions for one join, or None.

        Keyed by both table versions: mutations clear join entries
        outright (``drop_joins``), so a surviving entry always matches —
        the version check is a defensive invariant, not a patch path."""
        jm = self._join_decisions.get(
            self._join_key(left_handle.name, right_handle.name, oracle, cfg))
        if jm is None:
            return None
        if (jm.left_version != left_handle.version
                or jm.right_version != right_handle.version
                or jm.pair_mask.shape != (len(left_handle),
                                          len(right_handle))):
            return None
        return jm

    def record_join(self, left_handle, right_handle, oracle, cfg,
                    pair_mask: np.ndarray) -> None:
        key = self._join_key(left_handle.name, right_handle.name, oracle,
                             cfg)
        self._oracles[key[2]] = oracle_identity(oracle)  # pin id stability
        self._join_decisions[key] = JoinDecisionMemo(
            left_version=left_handle.version,
            right_version=right_handle.version,
            pair_mask=np.asarray(pair_mask, bool).copy(),
            fingerprint=key[3])
        if self.hook is not None:
            self.hook("join", left=left_handle.name,
                      right=right_handle.name,
                      ident=oracle_identity(oracle),
                      jm=self._join_decisions[key])

    def drop_joins(self, table: str) -> int:
        """Mutation of ``table``: drop every join decision touching it on
        either side (pair ids reindex / payloads changed — same rule as
        the pair-oracle memo clear).  Returns entries dropped."""
        stale = [k for k in self._join_decisions if table in k[:2]]
        for k in stale:
            del self._join_decisions[k]
        return len(stale)


class ReuseView:
    """Per-query binding of the session memo to one table handle.

    Implements the ``PlanExecutor`` memo protocol (``lookup``/``record``)
    plus the planning-side helpers the query layer uses (``pred_stats``,
    ``store_pilot``).  ``reuse_decisions`` / ``reuse_stats`` mirror the
    policy's ``reuse_memo`` / ``reuse_stats`` knobs; recording is always on
    (observations are free), reading is gated.
    """

    def __init__(self, session, handle, reuse_decisions: bool,
                 reuse_stats: bool):
        self.session = session
        self.handle = handle
        self.memo: SessionMemo = session.memo
        self.reuse_decisions = reuse_decisions
        self.reuse_stats = reuse_stats

    # ------------------------------------------------------ executor side
    def lookup(self, leaf: Pred, cfg: CSVConfig) -> Optional[ReplayHit]:
        if not self.reuse_decisions:
            return None
        # read-only: no strong ref is pinned (record()/store_pilot() pin
        # one the moment an entry is actually stored)
        key = (self.handle.name, id(oracle_identity(leaf.oracle)))
        # decisions are kept per config fingerprint: runs under different
        # semantics (xi, vote, seed, ...) never clobber each other
        dm = self.memo._decisions.get(key + (cfg_fingerprint(cfg),))
        if dm is None:
            return None
        n_now = len(self.handle)
        if dm.version == self.handle.version:
            if dm.n != n_now:  # defensive: version must imply same length
                return None
            return ReplayHit(mask=dm.mask, replay_rows=np.arange(dm.n),
                             rerun_rows=np.empty(0, dtype=np.int64))
        # table mutated since the memo: replay clean clusters, re-vote dirty
        ckey = (int(cfg.n_clusters), int(cfg.seed))
        if dm.cluster_key != ckey:
            return None
        dirty_version = self.handle._dirty.get(ckey)
        assign = self.session._assign_cache.get((self.handle.name, *ckey))
        if dirty_version is None or assign is None or len(assign) != n_now:
            return None
        clean = (dirty_version <= dm.version)[assign]
        replay_rows = np.nonzero(clean)[0]
        if len(replay_rows) == 0:
            return None  # everything dirty: the cold path is simpler
        if replay_rows[-1] >= dm.n:
            # a clean cluster contains a row newer than the memo — the dirty
            # bookkeeping was bypassed; fall back to a cold run
            return None
        # the executor incs memo.dirty_clusters when it consumes the hit —
        # planning probes call lookup() too and must not double-count
        return ReplayHit(mask=dm.mask, replay_rows=replay_rows,
                         rerun_rows=np.nonzero(~clean)[0],
                         n_dirty_clusters=int(
                             (dirty_version > dm.version).sum()))

    def record(self, leaf: Pred, cfg: CSVConfig, fr: FilterResult,
               live: np.ndarray) -> None:
        """Observe one executed leaf.  Only FULL-table runs update the
        selectivity observation and the decision memo: a cascade-restricted
        run measures a pass rate *conditional* on the upstream predicates
        (correlated predicates can make it arbitrarily far from the
        marginal), which would corrupt later cost orderings."""
        n_in = int(len(live))
        if n_in != len(self.handle):
            return
        key = self.memo._pred_key(self.handle.name, leaf.oracle)
        n_out = int(fr.mask.sum())
        lo = 1.0 / (n_in + 1)
        sel = min(1.0 - lo, max(lo, n_out / max(n_in, 1)))
        prev = self.memo._selectivity.get(key)
        tokens = ((fr.input_tokens + fr.output_tokens) / fr.n_llm_calls
                  if fr.n_llm_calls else
                  (prev.tokens_per_call if prev is not None else 64.0))
        self.memo._selectivity[key] = SelObservation(
            version=self.handle.version, selectivity=sel,
            tokens_per_call=tokens)
        fp = cfg_fingerprint(cfg)
        self.memo._decisions[key + (fp,)] = DecisionMemo(
            version=self.handle.version, n=n_in, mask=fr.mask.copy(),
            cluster_key=(int(cfg.n_clusters), int(cfg.seed)),
            fingerprint=fp)
        if self.memo.hook is not None:
            ident = oracle_identity(leaf.oracle)
            self.memo.hook("selectivity", table=self.handle.name,
                           ident=ident, obs=self.memo._selectivity[key])
            self.memo.hook("decision", table=self.handle.name, ident=ident,
                           dm=self.memo._decisions[key + (fp,)])

    # ------------------------------------------------------ planning side
    def pred_stats(self, leaf: Pred, cfg: CSVConfig, seed: int,
                   pilot_size: int) -> Optional[PredStats]:
        """Memoized PredStats for one leaf, or None to pilot-probe it.

        Served stats carry ``pilot_calls=0``: the spend happened (and was
        reported) in the query that originally paid it.

        Everything here is PLANNING-side reuse, so all of it — including
        costing a replayable leaf at zero — is gated on ``reuse_stats``:
        with it off the optimizer plans exactly like a cold session
        (pilot-probed, normally costed) and only the executor replays."""
        if not self.reuse_stats:
            return None
        key = (self.handle.name, id(oracle_identity(leaf.oracle)))
        hit = self.lookup(leaf, cfg)
        if hit is not None and hit.full:
            obs = self.memo._selectivity.get(key)
            sel = (obs.selectivity if obs is not None
                   else float(np.clip(hit.mask.mean(), 0.01, 0.99)))
            return PredStats(name=leaf.name, selectivity=sel,
                             tokens_per_call=0.0, n_pilot=0, pilot_calls=0,
                             source="memo", replayable=True)
        obs = self.memo._selectivity.get(key)
        if obs is not None and obs.version == self.handle.version:
            # version-gated: a mutation can shift the marginal pass rate,
            # so stale observations fall through to the pilot (also
            # version-keyed) or a fresh probe
            return PredStats(name=leaf.name, selectivity=obs.selectivity,
                             tokens_per_call=obs.tokens_per_call,
                             n_pilot=0, pilot_calls=0, source="observed")
        ps = self.memo._pilots.get(
            key + (self.handle.version, int(seed), int(pilot_size)))
        if ps is not None:
            return dataclasses.replace(
                ps, name=leaf.name, pilot_calls=0, pilot_input_tokens=0,
                pilot_output_tokens=0)
        return None

    def store_pilot(self, leaf: Pred, seed: int, pilot_size: int,
                    stats: PredStats) -> None:
        key = self.memo._pred_key(self.handle.name, leaf.oracle)
        self.memo._pilots[
            key + (self.handle.version, int(seed), int(pilot_size))] = stats
        if self.memo.hook is not None:
            self.memo.hook("pilot", table=self.handle.name,
                           ident=oracle_identity(leaf.oracle),
                           version=self.handle.version, seed=int(seed),
                           pilot_size=int(pilot_size), stats=stats)
