"""Standing-query watcher: continuous ingestion + incremental evaluation.

``StreamWatcher`` is the control loop tying the stream layer to the
session, plan and service layers.  Once per **tick** it:

1. polls every registered ``StreamSource`` (deterministic arrivals) and
   drains each up to its ``RateBudget`` — excess rows stay in the
   source's backlog (deferred, never dropped);
2. ingests the drained rows through ONE ``TableHandle.coalescing_appends``
   block, so a tick pays one precluster patch and one dirty-set union no
   matter how many sources contributed;
3. evaluates every registered ``StandingQuery`` — each is a lazy
   ``FilterQuery`` kept warm across ticks, so the session memo replays
   clean clusters and re-votes only the clusters this tick's rows
   touched: per-tick oracle cost is proportional to *touched clusters*,
   not table size.  Evaluation goes through the session's
   ``QueryScheduler`` (cross-query oracle batching) or, when a
   ``FilterService`` + tenant is attached, through tenant admission on
   top;
4. diffs each query's mask against its last acknowledged mask
   (``DeltaTracker``), content-dedups, and pushes exactly the
   newly-matching rows to the query's sink via its retrying
   ``SinkRunner``;
5. optionally checkpoints: ``SessionStore.save`` (decisions, clustering,
   oracle memos) plus a stream sidecar (tick counter, per-source
   cursors, per-query acked masks and seen-sets).

**Restart contract** (tests/test_torch_stream.py): a killed watcher rebuilt
over the same sources and queries calls ``restore()``, which replays the
*ingestion* of ticks 1..k (pure row appends — zero oracle calls, no
clustering), binds the checkpointed session state back on, and restores
the delta trackers; ticks k+1..n then notify exactly the rows the
unkilled run would have, with no duplicate notifications and near-zero
oracle replay.  See docs/streaming.md.

The watcher is host code.  A tick's device work is its session's: the
coalesced append patches the new rows onto the frozen centroids (K1),
the re-votes score the dirty clusters (K3 under SimVote) and model
oracles prefill their prompts (K4), all on the session's device.  Under
the scheduler those launches come from the query threads, on the
default stream.  The sidecar goes through ``checkpoint.manager`` in the
reference's format (``STREAM_SCHEMA`` 1), so each package restores the
other's checkpoints.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.checkpoint.manager import load_pytree, save_pytree
from repro_torch.obs.flight import get_flight_recorder
from repro_torch.obs.health import get_monitor
from repro_torch.obs.trace import get_tracer
from repro_torch.stream.delta import DeltaTracker, row_key
from repro_torch.stream.sinks import Sink, SinkRunner, StdoutSink
from repro_torch.stream.source import RateBudget, StreamSource

STREAM_SCHEMA = 1


@dataclasses.dataclass
class StreamStats:
    """Watcher-level accounting (per-query spend stays on the oracles)."""
    n_ticks: int = 0
    n_rows_arrived: int = 0
    n_rows_ingested: int = 0
    n_rows_deferred: int = 0      # backlog rows left waiting by quotas
    n_oracle_calls: int = 0       # cumulative across standing queries
    n_notifications: int = 0
    n_checkpoints: int = 0

    def metrics_view(self) -> dict:
        return {
            "stream.ticks": self.n_ticks,
            "stream.rows_ingested": self.n_rows_ingested,
            "stream.rows_deferred": self.n_rows_deferred,
            "stream.oracle_calls": self.n_oracle_calls,
            "stream.notifications": self.n_notifications,
            "stream.checkpoints": self.n_checkpoints,
        }


class StandingQuery:
    """One registered predicate: a lazy query kept warm across ticks,
    its delta tracker, and its sink runner."""

    def __init__(self, name: str, predicate, runner: SinkRunner,
                 policy=None):
        self.name = name
        self.predicate = predicate    # str (registered oracle) or Expr
        self.runner = runner
        self.policy = policy
        self.delta = DeltaTracker()
        self.query = None             # built when the table exists

    def bind(self, handle) -> None:
        if self.query is None:
            self.query = handle.filter(self.predicate, policy=self.policy)


class StreamWatcher:
    """Tick loop over sources, standing queries, sinks, and checkpoints.

        watcher = StreamWatcher(session, table_name="feed", store=store)
        watcher.add_source(src, RateBudget(rows_per_tick=32))
        watcher.register("positive", sink=JsonlSink("hits.jsonl"))
        watcher.run(n_ticks=50)

    ``register`` predicates name oracles registered on the session
    (``session.register_oracle``) — the durable identity the
    ``SessionStore`` needs for zero-replay restarts.
    """

    def __init__(self, session, table_name: str = "stream",
                 store=None, tag: str = "watch",
                 checkpoint_every: Optional[int] = None,
                 service=None, tenant: Optional[str] = None,
                 use_scheduler: bool = True):
        self.session = session
        self.table_name = table_name
        self.store = store
        self.tag = tag
        self.checkpoint_every = checkpoint_every
        self.service = service
        self.tenant = tenant
        if service is not None and tenant is None:
            raise ValueError("a FilterService watcher needs tenant=")
        self.use_scheduler = use_scheduler
        self.stats = StreamStats()
        self.handle = session._tables.get(table_name)
        self.row_keys: List[str] = []
        if self.handle is not None:
            self._rekey_existing_rows()
        self._sources: List[tuple] = []          # (source, budget)
        self._queries: Dict[str, StandingQuery] = {}
        self._tick = 0
        self._evaluated_version = -1
        self._shutdown_done = False

    # ------------------------------------------------------------- wiring
    def add_source(self, source: StreamSource,
                   budget: Optional[RateBudget] = None) -> StreamSource:
        if any(s.name == source.name for s, _ in self._sources):
            raise ValueError(f"source {source.name!r} already added")
        self._sources.append((source, budget or RateBudget()))
        return source

    def register(self, predicate, sink: Optional[Sink] = None,
                 name: Optional[str] = None, retries: int = 2,
                 policy=None) -> StandingQuery:
        """Register a standing query.  ``predicate`` is a session oracle
        name (recommended: durable across restarts) or a plan ``Expr``."""
        name = name or (predicate if isinstance(predicate, str)
                        else f"q{len(self._queries)}")
        if name in self._queries:
            raise ValueError(f"standing query {name!r} already registered")
        dl_path = (self.store.dir / f"{self.tag}-deadletter.jsonl"
                   if self.store is not None else None)
        runner = SinkRunner(sink or StdoutSink(), retries=retries,
                            dead_letter_path=dl_path)
        sq = StandingQuery(name, predicate, runner, policy=policy)
        if self.handle is not None:
            sq.bind(self.handle)
        self._queries[name] = sq
        return sq

    @property
    def queries(self) -> Dict[str, StandingQuery]:
        return dict(self._queries)

    def _rekey_existing_rows(self) -> None:
        t = self.handle._table
        texts = t.texts
        emb = t._embeddings
        self.row_keys = [
            row_key(texts[i] if texts is not None else None,
                    emb[i] if texts is None else None)
            for i in range(len(self.handle))]

    # --------------------------------------------------------------- tick
    def _ingest_tick(self, tick: int) -> int:
        """Phase 1+2 of one tick: poll sources, drain within budgets,
        coalesced-append into the table.  Pure w.r.t. oracles — restart
        replay runs exactly this for ticks 1..k."""
        drained: List[tuple] = []     # (source, rows)
        deferred = 0
        for src, budget in self._sources:
            arrived_before = src.arrived
            backlog = src.poll(tick)
            self.stats.n_rows_arrived += src.arrived - arrived_before
            rows = src.take(budget.cap(backlog))
            deferred += src.backlog
            if rows:
                drained.append((src, rows))
        self.stats.n_rows_deferred = deferred
        n_ing = sum(len(rows) for _, rows in drained)
        if n_ing == 0:
            return 0
        batches = []
        for _src, rows in drained:
            texts = ([r.text for r in rows]
                     if all(r.text is not None for r in rows) else None)
            embs = (np.stack([r.embedding for r in rows])
                    if all(r.embedding is not None for r in rows) else None)
            batches.append((texts, embs))
            self.row_keys.extend(
                row_key(r.text, r.embedding) for r in rows)
        if self.handle is None:
            # first rows create the table; later ticks append into it
            first_t, first_e = batches[0]
            self.handle = self.session.table(
                texts=first_t, embeddings=first_e, name=self.table_name)
            batches = batches[1:]
            for sq in self._queries.values():
                sq.bind(self.handle)
        if batches:
            with self.handle.coalescing_appends():
                for texts, embs in batches:
                    self.handle.append(texts=texts, embeddings=embs)
        self.stats.n_rows_ingested += n_ing
        return n_ing

    def _evaluate(self) -> List[tuple]:
        """Phase 3: evaluate every standing query; returns
        ``[(sq, QueryResult), ...]``."""
        sqs = list(self._queries.values())
        for sq in sqs:
            sq.bind(self.handle)
        if self.service is not None:
            tickets = [self.service.submit(self.tenant, sq.query,
                                           policy=sq.policy, label=sq.name)
                       for sq in sqs]
            results = self.service.gather(*tickets)
        elif self.use_scheduler:
            with self.session.scheduler.holding():
                tickets = [self.session.submit(sq.query, policy=sq.policy)
                           for sq in sqs]
            results = [t.result() for t in tickets]
        else:
            results = [sq.query.collect(sq.policy) for sq in sqs]
        self._evaluated_version = self.handle.version
        return list(zip(sqs, results))

    def _notify(self, sq: StandingQuery, result) -> int:
        """Phase 4: delta -> dedup -> sink -> ack for one query."""
        emit_rows, deduped = sq.delta.delta(result.mask, self.row_keys)
        sq.runner.note_deduped(deduped)
        texts = self.handle._table.texts
        for i in emit_rows:
            sq.runner.deliver({
                "query": sq.name, "tick": self._tick, "row": int(i),
                "key": self.row_keys[i],
                "text": texts[i] if texts is not None else None})
        sq.delta.ack(result.mask)
        return len(emit_rows)

    def tick(self) -> dict:
        """Run one full tick; returns a summary dict."""
        if not self._sources:
            raise RuntimeError("no sources added")
        self._tick += 1
        tr = get_tracer()
        with tr.span("stream_tick", kind="stream_tick",
                     tick=self._tick) as sp:
            n_ing = self._ingest_tick(self._tick)
            calls = notified = 0
            fresh_rows = (self.handle is not None
                          and self.handle.version != self._evaluated_version)
            if self.handle is not None and (n_ing or fresh_rows):
                for sq, result in self._evaluate():
                    calls += int(result.n_llm_calls)
                    notified += self._notify(sq, result)
            self.stats.n_ticks += 1
            self.stats.n_oracle_calls += calls
            self.stats.n_notifications += notified
            backlog = sum(s.backlog for s, _ in self._sources)
            tr.metrics.inc("stream.ticks")
            tr.metrics.inc("stream.rows_ingested", n_ing)
            tr.metrics.inc("stream.oracle_calls", calls)
            tr.metrics.inc("stream.notifications", notified)
            # tick lag: rows the budgeted sources are still holding back —
            # a growing gauge means ticks are not draining arrivals
            tr.metrics.set("stream.tick_lag_rows", backlog)
            if tr.enabled and n_ing:
                self._export_centroid_drift(n_ing, tr)
            sp.set(rows=n_ing, oracle_calls=calls, notified=notified,
                   n_rows=0 if self.handle is None else len(self.handle))
        # health heartbeat + flight-recorder metric deltas (null defaults)
        get_monitor().maybe_evaluate()
        fr = get_flight_recorder()
        if fr is not None:
            fr.record_delta()
        if (self.checkpoint_every and self.store is not None
                and self._tick % self.checkpoint_every == 0):
            self.checkpoint()
        return {"tick": self._tick, "rows": n_ing, "oracle_calls": calls,
                "notified": notified, "backlog": backlog}

    def _export_centroid_drift(self, n_new: int, tr) -> None:
        """Relative distance between this tick's new rows and the table's
        running mean embedding.  The stream table's cluster centroids are
        frozen at creation (docs/streaming.md), so sustained drift means
        the 4-way partition is degrading — the ``stream-centroid-drift``
        health rule alerts on this gauge."""
        if self.handle is None:
            return
        emb = self.handle._table._embeddings
        if emb is None or len(emb) == 0 or n_new > len(emb):
            return
        center = emb.mean(axis=0)
        drift = float(np.linalg.norm(emb[-n_new:].mean(axis=0) - center)
                      / (np.linalg.norm(center) + 1e-9))
        tr.metrics.set("stream.centroid_drift", drift)

    def status_view(self) -> dict:
        """statusz section: tick progress, backlog, per-query delivery."""
        return {
            "tick": self._tick,
            "n_rows": 0 if self.handle is None else len(self.handle),
            "backlog": sum(s.backlog for s, _ in self._sources),
            "drained": self.drained,
            "ticks": self.stats.n_ticks,
            "oracle_calls": self.stats.n_oracle_calls,
            "notifications": self.stats.n_notifications,
            "queries": sorted(self._queries),
        }

    @property
    def drained(self) -> bool:
        """Every source fully arrived AND ingested (no pending work)."""
        return all(s.exhausted for s, _ in self._sources)

    def run(self, n_ticks: Optional[int] = None,
            shutdown=None) -> List[dict]:
        """Tick until sources drain (or ``n_ticks``); between ticks honor
        a flag-mode ``GracefulShutdown``.  Returns per-tick summaries."""
        out = []
        while n_ticks is None or len(out) < n_ticks:
            if shutdown is not None and shutdown.requested:
                break
            out.append(self.tick())
            if n_ticks is None and self.drained:
                break
        return out

    # --------------------------------------------------------- checkpoint
    def _sidecar_dir(self):
        return self.store.dir / f"{self.tag}-stream"

    def has_checkpoint(self) -> bool:
        """A restorable stream sidecar exists in the store directory."""
        return (self.store is not None
                and (self._sidecar_dir() / "MANIFEST.json").exists())

    def checkpoint(self) -> None:
        """Durable snapshot: session state + stream sidecar."""
        if self.store is None:
            raise ValueError("StreamWatcher built without store=")
        if self.handle is not None:
            self.store.save(self.session, tag=self.tag)
        arrays = {}
        queries = {}
        for name, sq in self._queries.items():
            arrays[f"acked/{name}"] = sq.delta.acked.astype(bool)
            queries[name] = {"n_acked": int(len(sq.delta.acked)),
                             **sq.delta.state()}
        meta = {"stream_schema": STREAM_SCHEMA, "tick": int(self._tick),
                "table": self.table_name,
                "n_rows": 0 if self.handle is None else len(self.handle),
                "sources": {s.name: s.state() for s, _ in self._sources},
                "queries": queries,
                "stats": dataclasses.asdict(self.stats)}
        save_pytree(arrays, self._sidecar_dir(), extra_meta=meta)
        self.stats.n_checkpoints += 1
        get_tracer().metrics.inc("stream.checkpoints")

    def restore(self):
        """Rebuild mid-stream state from the last checkpoint.

        Call on a FRESH watcher whose session has the same oracles
        registered and whose sources/queries match the killed run;
        replays ingestion ticks 1..k (deterministic, zero oracle calls),
        then binds the session checkpoint back on.  Returns the
        ``RestoreReport`` from ``SessionStore.load``."""
        if self.store is None:
            raise ValueError("StreamWatcher built without store=")
        by_key, meta = load_pytree(self._sidecar_dir())
        if meta.get("stream_schema") != STREAM_SCHEMA:
            raise ValueError(
                f"stream sidecar schema {meta.get('stream_schema')!r} "
                f"does not match this build ({STREAM_SCHEMA})")
        if self._tick or self.handle is not None and len(self.handle):
            raise RuntimeError("restore() needs a fresh watcher")
        # 1. replay ingestion (rows only — no queries, no clustering)
        for t in range(1, meta["tick"] + 1):
            self._ingest_tick(t)
        self._tick = meta["tick"]
        n_rows = 0 if self.handle is None else len(self.handle)
        if n_rows != meta["n_rows"]:
            raise ValueError(
                f"ingestion replay rebuilt {n_rows} rows, checkpoint "
                f"recorded {meta['n_rows']} — sources or budgets differ "
                "from the killed run")
        for src, _ in self._sources:
            saved = meta["sources"].get(src.name)
            if saved is None or src.state() != saved:
                raise ValueError(
                    f"source {src.name!r} replay state {src.state()} != "
                    f"checkpointed {saved} — not the same stream schedule")
        # 2. session state: clustering, dirty versions, decisions, memos
        report = self.store.load(self.session, tag=self.tag) \
            if self.handle is not None else None
        # 3. delta trackers + cumulative stats
        for name, sq in self._queries.items():
            saved = meta["queries"].get(name)
            if saved is None:
                continue
            acked = (np.asarray(by_key[f"acked/{name}"], dtype=bool)
                     if saved["n_acked"] else np.zeros(0, dtype=bool))
            sq.delta.restore_state(saved, acked)
        st = meta["stats"]
        self.stats = StreamStats(**st)
        return report

    # ----------------------------------------------------------- shutdown
    def shutdown(self) -> None:
        """Final checkpoint + sink flush (idempotent) — the cleanup a
        ``GracefulShutdown`` registers for SIGINT/SIGTERM."""
        if self._shutdown_done:
            return
        self._shutdown_done = True
        for sq in self._queries.values():
            sq.runner.flush()
        if self.store is not None:
            self.checkpoint()
        for sq in self._queries.values():
            sq.runner.close()

    # ------------------------------------------------------------ metrics
    def metrics_view(self) -> dict:
        """Unified-name view (stream counters + summed sink counters) for
        ``MetricsRegistry.sync_from``."""
        view = self.stats.metrics_view()
        agg = {"sink.delivered": 0, "sink.deduped": 0,
               "sink.dead_lettered": 0, "sink.retries": 0}
        for sq in self._queries.values():
            for k, v in sq.runner.stats.metrics_view().items():
                agg[k] += v
        view.update(agg)
        return view
