"""Session: the shared-resource scope of the declarative query API.

A ``Session`` owns everything that outlives a single query:

- the **precluster cache**, keyed by ``(table id, n_clusters, seed)`` so two
  tables in one session can never share a k-means assignment (the legacy
  per-table cache was keyed by ``(n_clusters, seed)`` only, which was safe
  per instance but impossible to share safely across tables);
- an **oracle registry** (name -> oracle [+ proxy]) so queries can refer to
  predicates declaratively by name;
- a run-level **OracleStats** aggregate — every ``collect()`` folds its
  per-oracle deltas (``BaseOracle.scope`` semantics) into ``session.stats``;
- an optional default **embedder** applied to text-only tables, and an
  optional ``ServingEngine`` for real-backbone oracles;
- the **device** every table's k-means, every vote and every join runs on
  (``"cuda"`` unless the caller asks for ``"cpu"``) and the k-means
  seeder hook ``init_centroids`` they all use.

``Session.table(...)`` returns a ``TableHandle`` whose ``.filter()`` /
``.join()`` build lazy queries (see ``repro_torch.api.query``).  Handles
satisfy the ``PlanExecutor`` table protocol (``embeddings``,
``precluster``, ``device``, ``init_centroids``, ``len``), so the plan layer
runs on them unchanged.

``submit``/``gather`` run queries concurrently through the session's
``repro_torch.service.QueryScheduler``; ``coordinator=`` shares one
dispatch lane between several sessions' schedulers; an attached
``repro_torch.service.log.SessionLogStore`` records every mutation and
precluster fit through the ``_session_log`` hooks.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.api.memo import SessionMemo
from repro_torch.api.policy import ExecutionPolicy
from repro_torch.api.query import FilterQuery, JoinQuery
from repro_torch.core.clustering import Seeder
from repro_torch.core.oracle import OracleStats
from repro_torch.core.operators import SemanticTable
from repro_torch.embeddings.cache import CachingEmbedder, EmbeddingCache
from repro_torch.obs.trace import get_tracer
from repro_torch.plan.expr import Expr, Pred
from repro_torch.utils.device import resolve_device


class TableHandle:
    """A table registered in a session.  Cheap identity object: the data
    lives in the wrapped ``SemanticTable``; clustering lives in the session
    cache.  ``append``/``update`` mutate the table *incrementally*: new or
    changed rows are embedded through the session's embedding cache,
    assigned to the nearest existing centroid, and only the touched
    clusters are marked dirty — the next ``collect`` of a memoized
    predicate re-votes exactly those clusters (docs/caching.md).

    ``version`` counts mutations; ``_dirty[(k, seed)][c]`` is the version
    at which cluster ``c`` of that cached clustering last changed.
    """

    def __init__(self, session: "Session", table: SemanticTable, name: str):
        self.session = session
        self.name = name
        self._table = table
        self.version = 0
        self._dirty: Dict[Tuple[int, int], np.ndarray] = {}
        # micro-batch ingestion buffer: non-None while inside a
        # ``coalescing_appends()`` block (list of (texts, embeddings))
        self._append_buffer: Optional[List[tuple]] = None

    def __len__(self) -> int:
        return len(self._table)

    def __repr__(self) -> str:
        return f"TableHandle({self.name!r}, n={len(self)})"

    @property
    def embeddings(self) -> np.ndarray:
        return self._table.embeddings

    @property
    def texts(self):
        return self._table.texts

    @property
    def device(self):
        """Where this table's k-means and its queries' votes run."""
        return self._table.device

    @property
    def init_centroids(self) -> Optional[Seeder]:
        return self._table.init_centroids

    def precluster(self, n_clusters: int, seed: int = 0) -> np.ndarray:
        """Offline clustering via the session cache (PlanExecutor protocol)."""
        return self.session._precluster(self, n_clusters, seed)

    # ------------------------------------------------- incremental updates
    def _resolve_embeddings(self, texts, embeddings) -> Optional[np.ndarray]:
        """Rows to add/patch: given embeddings win; else embed texts through
        the session cache (only while the table's embeddings are
        materialized — a still-lazy table defers to its embedder)."""
        if embeddings is not None:
            return np.asarray(embeddings, np.float32)
        if self._table._embeddings is None:
            return None  # still lazy: the (caching) embedder runs later
        embedder = self._table._embedder or self.session.embedder
        if embedder is None:
            raise ValueError(f"table {self.name!r} has materialized "
                             "embeddings but no embedder; pass embeddings=")
        if not (isinstance(embedder, CachingEmbedder)
                and embedder.cache is self.session.embedding_cache):
            # tables registered with embeddings= carry a raw embedder (the
            # table() wrap only covers lazy-text tables) — route mutations
            # through THIS session's cache regardless
            embedder = CachingEmbedder(self.session.embedding_cache, embedder)
        return np.asarray(embedder(list(texts)), np.float32)

    def _apply_touched(self, touched: Dict) -> None:
        """Fold a SemanticTable patch report into the session cache and the
        per-cluster dirty versions (at the freshly bumped version)."""
        for (k, seed), (assign, touched_clusters) in touched.items():
            self.session._assign_cache[(self.name, k, seed)] = assign
            dirty = self._dirty.setdefault(
                (k, seed), np.full(k, self.version, dtype=np.int64))
            dirty[touched_clusters] = self.version

    def append(self, texts: Optional[Sequence[str]] = None,
               embeddings=None) -> "TableHandle":
        """Add rows without invalidating the precluster cache: new rows are
        embedded through the session's embedding cache and assigned to the
        nearest existing centroids; only the clusters that received rows
        are marked dirty (memoized predicates re-vote exactly those).

        Note: oracles index tuples by id — an oracle bound to this table
        must cover the grown id range (synthetic oracles: build them over
        the post-append labels).
        """
        if texts is None and embeddings is None:
            raise TypeError("append needs texts= and/or embeddings=")
        n_new = len(texts) if texts is not None else len(embeddings)
        if n_new == 0:
            return self  # no rows: don't bump the version for a no-op
        if self._append_buffer is not None:
            # micro-batch mode: park the rows; one _append_rows call (one
            # precluster patch, one dirty-set union, one version bump)
            # happens at coalescing_appends() exit.  Embedding resolution
            # is deferred too, so buffered text rows still embed through
            # the session cache exactly as the per-append path would.
            self._append_buffer.append(
                (list(texts) if texts is not None else None,
                 np.asarray(embeddings, np.float32)
                 if embeddings is not None else None))
            return self
        new_emb = self._resolve_embeddings(texts, embeddings)
        touched = self._table._append_rows(
            list(texts) if texts is not None else None, new_emb)
        self.version += 1
        self._apply_touched(touched)
        get_tracer().metrics.inc("session.append_rows", n_new)
        # growing a table reindexes pair ids of joins against it
        self.session._clear_pair_oracles(self.name)
        self.session._log_mutation(
            "append", self, texts=list(texts) if texts is not None else None,
            embeddings=new_emb)
        return self

    @contextlib.contextmanager
    def coalescing_appends(self):
        """Micro-batch ingestion: coalesce every ``append()`` inside the
        block into ONE table mutation at exit.

        High-frequency small appends (a stream tick draining several
        sources) pay one nearest-centroid precluster patch, one dirty-set
        union, and one version bump instead of one of each per call.
        Bit-identity to the per-append path: centroids do not move during
        a patch, so per-row nearest-centroid assignment is independent of
        batch composition, and the rerun set of a later memoized collect —
        members of clusters dirtied since the memo's version — is exactly
        the union the per-append path would dirty (asserted in
        tests/test_torch_api.py).  Reads inside the block (``len``,
        ``embeddings``, ``collect``) see the PRE-append table; reentrant
        blocks coalesce into the outermost one.
        """
        if self._append_buffer is not None:
            yield self   # nested: the outermost block owns the flush
            return
        self._append_buffer = []
        try:
            yield self
        finally:
            buf, self._append_buffer = self._append_buffer, None
            self._flush_appends(buf)

    def _flush_appends(self, buf: List[tuple]) -> None:
        """Apply buffered appends as one mutation (see coalescing_appends)."""
        if not buf:
            return
        has_texts = [t is not None for t, _ in buf]
        if any(has_texts) != all(has_texts):
            raise ValueError(
                "coalesced appends mix texts= and embeddings-only rows; "
                "a single micro-batch must use one form")
        texts: Optional[List[str]] = None
        if all(has_texts):
            texts = [s for t, _ in buf for s in t]
        # resolve each buffered batch exactly as append() would have (given
        # embeddings win; text rows embed through the session cache), then
        # concatenate into one patch
        embs = [self._resolve_embeddings(t, e) for t, e in buf]
        if any(e is None for e in embs) != all(e is None for e in embs):
            raise ValueError(
                "coalesced appends mix lazy-embedding and materialized "
                "rows; a single micro-batch must use one form")
        new_emb = (np.concatenate(embs)
                   if embs[0] is not None else None)
        touched = self._table._append_rows(texts, new_emb)
        self.version += 1
        self._apply_touched(touched)
        n_new = len(texts) if texts is not None else len(new_emb)
        get_tracer().metrics.inc("session.append_rows", n_new)
        self.session._clear_pair_oracles(self.name)
        self.session._log_mutation("append", self, texts=texts,
                                   embeddings=new_emb)

    def update(self, ids, texts: Optional[Sequence[str]] = None,
               embeddings=None) -> "TableHandle":
        """Replace rows in place (§3.1 update handling): changed rows are
        re-embedded through the session cache and re-assigned to the
        nearest centroid; their old and new clusters are marked dirty, and
        every oracle the session has seen touch this table drops its per-id
        memo entries for ``ids`` (the tuple content changed under them).
        """
        ids = np.asarray(ids, dtype=np.int64)
        if len(ids) == 0:
            return self
        if texts is None and embeddings is None:
            raise TypeError("update needs texts= and/or embeddings=")
        new_emb = self._resolve_embeddings(texts, embeddings)
        touched = self._table._update_rows(ids, texts, new_emb)
        self.version += 1
        self._apply_touched(touched)
        self.session._invalidate_oracles(self.name, ids)
        self.session._log_mutation(
            "update", self, ids=ids,
            texts=list(texts) if texts is not None else None,
            embeddings=new_emb)
        return self

    # ------------------------------------------------------------ queries
    def filter(self, predicate, oracle=None, *, proxy=None,
               policy: Optional[ExecutionPolicy] = None,
               name: Optional[str] = None) -> FilterQuery:
        """Build a lazy filter query (no oracle calls until ``collect``).

        Accepted forms:
        - ``filter(expr)`` — a ``repro_torch.plan`` expression (``Pred``/``And``/
          ``Or``/``Not``); each leaf carries its own oracle.
        - ``filter("name", oracle)`` — single predicate bound inline.
        - ``filter("name")`` — predicate looked up in the session's oracle
          registry (``register_oracle``); a registered proxy rides along.
        - ``filter(oracle, name="...")`` — bare oracle; the name defaults to
          ``"<table>.p<k>"``.
        """
        if isinstance(predicate, Expr):
            if oracle is not None:
                raise TypeError("filter(expr) does not take a second oracle "
                                "argument; bind oracles on the Pred leaves")
            expr = predicate
        elif isinstance(predicate, str):
            if oracle is None:
                oracle, reg_proxy = self.session._lookup_oracle(predicate)
                proxy = proxy if proxy is not None else reg_proxy
            expr = Pred(predicate, oracle)
        elif callable(predicate) or hasattr(predicate, "stats"):
            pred_name = name or self.session._anon_pred_name(self)
            expr = Pred(pred_name, predicate)
        else:
            raise TypeError(
                f"unsupported predicate {type(predicate).__name__}; expected "
                "a plan Expr, a predicate name, or an oracle callable")
        return FilterQuery(self.session, self, expr, policy=policy,
                           proxy=proxy)

    def join(self, right, oracle, *,
             policy: Optional[ExecutionPolicy] = None) -> JoinQuery:
        """Build a lazy semantic join against another table.

        oracle: callable over flat pair ids ``i * len(right) + j`` (see
        ``repro_torch.plan.join.pair_ids``) with ``.stats`` accounting.
        """
        if isinstance(right, SemanticTable):
            right = self.session.table(table=right)
        if not isinstance(right, TableHandle):
            raise TypeError(f"join target must be a TableHandle or "
                            f"SemanticTable, got {type(right).__name__}")
        if right.session is not self.session:
            raise ValueError("join requires both tables in the same session")
        return JoinQuery(self.session, self, right, oracle, policy=policy)


class Session:
    """Scope object for the lazy query API (the canonical entry point).

    device: where every table's k-means, every vote and every join of the
    session runs; ``"cuda"`` unless the caller asks for ``"cpu"`` (raises
    without a GPU otherwise).  init_centroids: the k-means seeder hook
    ``(seed, x, k) -> (k, D)`` passed to every table and join (default
    ``repro_torch.core.clustering.plusplus_init``).  coordinator: an
    optional ``repro_torch.distributed.DispatchCoordinator`` whose one
    dispatch lane this session's scheduler shares with others'.
    """

    def __init__(self, policy: Optional[ExecutionPolicy] = None,
                 embedder: Optional[Callable] = None, engine=None,
                 embedding_cache: Optional[EmbeddingCache] = None,
                 coordinator=None, *,
                 init_centroids: Optional[Seeder] = None, device="cuda"):
        self.device = resolve_device(device)
        self.init_centroids = init_centroids
        self.policy = policy or ExecutionPolicy()
        self.embedder = embedder
        self.engine = engine  # optional ServingEngine for ModelOracles
        # optional repro_torch.distributed.DispatchCoordinator: several
        # sessions' schedulers feed one merged dispatch lane
        self.coordinator = coordinator
        # content-hash keyed embedding store: per-session by default; pass
        # one cache to several sessions to share embeddings explicitly
        # explicit None check: an empty cache is falsy (__len__ == 0), so
        # ``or`` would silently drop a freshly shared cache
        self.embedding_cache = (embedding_cache if embedding_cache is not None
                                else EmbeddingCache())
        # cross-query memo: decisions, pilot probes, observed selectivities
        # (docs/caching.md; gated per query by ExecutionPolicy.reuse_*)
        self.memo = SessionMemo()
        self.stats = OracleStats()        # LLM-oracle spend across collects
        self.proxy_stats = OracleStats()  # cheap cascade-proxy spend, apart
        self._tables: Dict[str, TableHandle] = {}
        self._by_table_id: Dict[int, TableHandle] = {}
        self._assign_cache: Dict[Tuple[str, int, int], np.ndarray] = {}
        self._oracles: Dict[str, Tuple[Any, Any]] = {}
        self._anon_tables = 0
        self._anon_preds = 0
        # shared-state guard for concurrent collects (repro_torch.service):
        # the precluster cache and the run-level stats aggregates are the
        # only session state written from query threads
        self._lock = threading.Lock()
        self._scheduler = None  # lazy repro_torch.service.QueryScheduler
        # attached repro_torch.service.log.SessionLogStore recorder (None
        # when the session is not log-backed); table mutations and
        # precluster fits notify it through _log_mutation/_log_precluster
        self._session_log = None

    # -------------------------------------------------------------- tables
    def table(self, texts: Optional[Sequence[str]] = None, embeddings=None,
              embedder: Optional[Callable] = None,
              name: Optional[str] = None,
              table: Optional[SemanticTable] = None) -> TableHandle:
        """Register a table and return its handle.

        Either pass raw data (``texts``/``embeddings``/``embedder``) or wrap
        an existing ``SemanticTable`` via ``table=``, which must live on the
        session's device.  Wrapping the same SemanticTable twice returns the
        existing handle.
        """
        if table is not None:
            if texts is not None or embeddings is not None:
                raise TypeError("pass either table= or texts=/embeddings=, "
                                "not both")
            if table.device != self.device:
                raise ValueError(
                    f"table is on {table.device}, the session on "
                    f"{self.device}; build it with device={str(self.device)!r}")
            existing = self._by_table_id.get(id(table))
            if existing is not None:
                if name is not None and name != existing.name:
                    raise ValueError(
                        f"table already registered as {existing.name!r}")
                return existing
        else:
            emb_fn = embedder or self.embedder
            if emb_fn is not None and texts is not None:
                # route lazy embedding through the session cache so
                # overlapping/updated tables embed only genuinely new rows
                emb_fn = CachingEmbedder(self.embedding_cache, emb_fn)
            table = SemanticTable(texts=texts, embeddings=embeddings,
                                  embedder=emb_fn,
                                  init_centroids=self.init_centroids,
                                  device=self.device)
        if name is None:
            name = f"t{self._anon_tables}"
            self._anon_tables += 1
        if name in self._tables:
            raise ValueError(f"table name {name!r} already registered")
        handle = TableHandle(self, table, name)
        self._tables[name] = handle
        self._by_table_id[id(table)] = handle
        return handle

    def __getitem__(self, name: str) -> TableHandle:
        return self._tables[name]

    # ------------------------------------------------------------- oracles
    def register_oracle(self, name: str, oracle, proxy=None) -> None:
        """Bind a predicate name to an oracle (and optional baseline proxy)
        so queries can say ``handle.filter("name")``."""
        if name in self._oracles:
            raise ValueError(f"oracle {name!r} already registered")
        self._oracles[name] = (oracle, proxy)
        if self._session_log is not None:
            self._session_log.bind_oracle(name, oracle)

    def oracle(self, name: str):
        return self._lookup_oracle(name)[0]

    def _lookup_oracle(self, name: str) -> Tuple[Any, Any]:
        try:
            return self._oracles[name]
        except KeyError:
            raise KeyError(f"no oracle registered under {name!r}; call "
                           "session.register_oracle(name, oracle) or pass "
                           "the oracle to .filter() directly") from None

    def _anon_pred_name(self, handle: TableHandle) -> str:
        name = f"{handle.name}.p{self._anon_preds}"
        self._anon_preds += 1
        return name

    # ---------------------------------------------------------- clustering
    def _precluster(self, handle: TableHandle, n_clusters: int,
                    seed: int) -> np.ndarray:
        """Cross-table-safe precluster cache.

        Keyed by (table name, k, seed) — table names are unique per session
        (the session-visible table id), so two tables can never share an
        assignment entry.  Computation delegates to the wrapped table's own
        per-instance memoized ``precluster``: that second layer is what
        keeps a SemanticTable wrapped by two sessions, or used directly, on
        one consistent assignment.
        """
        key = (handle.name, int(n_clusters), int(seed))
        if key not in self._assign_cache:
            # serialized: concurrent service queries on one table must not
            # race the (deterministic but expensive) k-means fit
            with self._lock:
                if key not in self._assign_cache:
                    assign, _ = handle._table.precluster_full(n_clusters,
                                                              seed)
                    self._assign_cache[key] = assign
                    # per-cluster dirty versions start at the clustering's
                    # birth version: decisions memoized from here on see
                    # clean clusters until append()/update() touches them
                    handle._dirty.setdefault(
                        (int(n_clusters), int(seed)),
                        np.full(int(n_clusters), handle.version,
                                dtype=np.int64))
                    if self._session_log is not None:
                        self._session_log.record_precluster(
                            handle, int(n_clusters), int(seed))
        return self._assign_cache[key]

    def _invalidate_oracles(self, table_name: str, ids: np.ndarray) -> None:
        """Update-path invalidation: drop stale per-id oracle memo entries
        for every oracle the session has seen touch ``table_name``.

        Sightings only, NOT the whole registry: tuple ids are plain ints,
        so invalidating a registered-but-unused oracle would drop its
        already-paid decisions for the *other* table it actually ran on.
        ``collect()`` registers every leaf oracle as a sighting even under
        reuse-disabled policies, so the sweep covers all relevant memos."""
        for oracle in self.memo.oracles_for(table_name):
            if hasattr(oracle, "memo_invalidate"):
                oracle.memo_invalidate(ids)
        self._clear_pair_oracles(table_name)

    def _clear_pair_oracles(self, table_name: str) -> None:
        """Pair (join) oracles memoize by pair id ``i * len(right) + j``:
        growing the right table reindexes every pair and updating either
        side changes pair payloads, so ANY mutation clears the whole memo
        of every join oracle sighted on the table — and the session-level
        join decision memo entries touching the table on either side."""
        for oracle in self.memo.pair_oracles_for(table_name):
            if hasattr(oracle, "memo_clear"):
                oracle.memo_clear()
        self.memo.drop_joins(table_name)

    # ------------------------------------------------------- durability log
    def _log_mutation(self, kind: str, handle: TableHandle, **fields) -> None:
        """Forward a table mutation to the attached session log (no-op for
        plain sessions)."""
        if self._session_log is not None:
            self._session_log.record_mutation(kind, handle, **fields)

    # ---------------------------------------------------------- accounting
    def _absorb(self, delta: OracleStats) -> None:
        with self._lock:
            self.stats.merge(delta)

    def _absorb_proxy(self, delta: OracleStats) -> None:
        with self._lock:
            self.proxy_stats.merge(delta)

    # ------------------------------------------------- concurrent service
    @property
    def scheduler(self):
        """The session's concurrent query scheduler (repro_torch.service),
        created on first use.  ``submit``/``gather`` are the front door;
        reach for the scheduler itself for ``holding()`` (batch several
        submissions into one admission wave) or ``stats``."""
        if self._scheduler is None:
            from repro_torch.service.scheduler import QueryScheduler
            self._scheduler = QueryScheduler(
                self, coordinator=self.coordinator)
        return self._scheduler

    def submit(self, query, policy: Optional[ExecutionPolicy] = None):
        """Schedule a query for concurrent execution; returns a
        ``QueryTicket`` (docs/service.md).  Oracle batches of all in-flight
        queries are merged into cross-query dispatches; per-query masks and
        call counts stay bit-identical to serial ``collect()``."""
        return self.scheduler.submit(query, policy=policy)

    def gather(self, *tickets):
        """Wait for submitted queries; returns their ``QueryResult``s (all
        outstanding tickets when called without arguments)."""
        return self.scheduler.gather(*tickets)

    def close(self) -> None:
        """Shut down the scheduler's worker threads (no-op when the
        concurrent service was never used)."""
        if self._scheduler is not None:
            self._scheduler.close()
            self._scheduler = None
