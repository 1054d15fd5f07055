"""Concurrent query scheduler: cross-query oracle batching with per-query
bit-identity.

``Session.submit()`` hands a lazy ``FilterQuery``/``JoinQuery`` to this
scheduler instead of collecting it inline.  Each submission becomes a
*task* whose ``collect()`` runs on its own worker thread, with every leaf
oracle rebound to a ``BatchingOracleProxy``: the proxy parks the calling
thread and enqueues the batch with the scheduler instead of evaluating it.
The scheduler loop is a barrier tick —

    when every in-flight task has a pending oracle batch, merge ALL
    pending batches (ordered by task submission, FIFO within a task) into
    one cross-query dispatch,

so the mean ids-per-invocation grows with concurrency (the serving layer
sees one large prompt wave instead of per-query trickles) while each
query's own oracle still evaluates exactly the batches, in exactly the
order, a serial ``collect()`` would produce.  Bit-identity argument:

- the CSV driver RNG, the pilot draw, and each oracle's flip stream are
  all per-query state — merging only *groups* evaluations, it never
  reorders them within a query (the merged dispatch drains through a
  single-lane ``AsyncOracleDispatcher``, strict FIFO);
- cross-query coupling exists ONLY through shared oracle objects (the
  session memo keys decisions/pilots/selectivities by oracle identity), so
  the scheduler defers any task whose leaf oracles intersect an in-flight
  task's — conflicting tasks run in submission order, exactly the serial
  interleaving, which is what lets a resubmitted predicate replay at zero
  calls under the scheduler too;
- shared session state written from task threads (precluster cache, run
  aggregates) is lock-guarded in ``Session``.

Mutating a table (``append``/``update``) while queries are in flight is
not supported — mutate between ``gather()`` and the next ``submit()``.

See docs/service.md for the full model.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from collections import deque
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np

from repro_torch.api.memo import oracle_identity
from repro_torch.api.query import FilterQuery, JoinQuery
from repro_torch.core.oracle import AsyncOracleDispatcher, evaluate_packed
from repro_torch.obs.health import get_monitor
from repro_torch.obs.trace import get_tracer
from repro_torch.plan.expr import And, Expr, Not, Or, Pred
from repro_torch.serving.batcher import DispatchMergeStats
from repro_torch.utils.timing import monotonic


class BatchingOracleProxy:
    """Stand-in for one task's leaf oracle: routes every batch through the
    scheduler (park -> merge -> evaluate), delegates everything else —
    ``stats``, ``scope``, ``memo_*`` — to the wrapped oracle.

    ``memo_target`` is the wrapped oracle, so session-memo entries
    recorded through the proxy replay for serial collects of the same
    predicate and vice versa (see ``repro_torch.api.memo.oracle_identity``).
    """

    def __init__(self, scheduler: "QueryScheduler", task: "_Task", inner):
        while isinstance(inner, BatchingOracleProxy):
            inner = inner.inner  # resubmitted query: never chain proxies
        self.inner = inner
        self.memo_target = oracle_identity(inner)
        self._scheduler = scheduler
        self._task = task

    def __call__(self, ids) -> np.ndarray:
        return self._scheduler._evaluate(self._task, self.inner, ids)

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __repr__(self):
        return f"BatchingOracleProxy({self.inner!r})"


@dataclasses.dataclass
class _OracleRequest:
    task: "_Task"
    oracle: object            # the UNWRAPPED oracle to evaluate with
    ids: np.ndarray
    future: Future
    # the requester's innermost open span (its round-level oracle span),
    # captured on the task thread at park time: the explicit cross-thread
    # edge parenting the dispatch_wave span run on the FIFO lane thread
    span: object = None


class _Task:
    """One scheduled query: proxied clone, worker thread, pending queue."""

    def __init__(self, index: int, label: str, policy):
        self.index = index
        self.label = label
        self.policy = policy
        self.query = None                  # proxied clone, set at submit
        self.oracle_refs: List = []        # strong refs -> stable ids
        self.oracle_ids: frozenset = frozenset()
        self.pending: deque = deque()
        self.future: Future = Future()
        self.thread: Optional[threading.Thread] = None
        self.finished = False
        self.deferred = False


class QueryTicket:
    """Handle to one submitted query (returned by ``Session.submit``)."""

    def __init__(self, scheduler: "QueryScheduler", task: _Task):
        self._scheduler = scheduler
        self._task = task
        self._gathered = False

    @property
    def label(self) -> str:
        return self._task.label

    @property
    def index(self) -> int:
        return self._task.index

    def done(self) -> bool:
        return self._task.future.done()

    @property
    def future(self) -> Future:
        """The underlying completion future — for callbacks and
        exception inspection; consume results via ``result()``/
        ``gather()`` (they also prune scheduler bookkeeping)."""
        return self._task.future

    def add_done_callback(self, fn) -> None:
        """Run ``fn(future)`` when the query finishes (immediately if it
        already has).  The service front end settles tenant budgets here,
        so settlement cannot be skipped by consuming the ticket directly."""
        self._task.future.add_done_callback(fn)

    def result(self, timeout: Optional[float] = None):
        """Block until the query completes; returns its ``QueryResult`` or
        re-raises the error its collect() hit.  A consumed ticket is
        dropped from the scheduler's bookkeeping (later no-arg ``gather``
        calls won't re-deliver it)."""
        if not self.done() and self._scheduler._hold > 0:
            # dispatch is paused: waiting here would deadlock — the parked
            # oracle batches can never be served until the hold is released
            raise RuntimeError(
                "ticket.result() inside scheduler.holding() would wait "
                "forever (dispatch is paused); exit the holding() block "
                "first")
        try:
            return self._task.future.result(timeout=timeout)
        finally:
            if self._task.future.done():
                self._scheduler._discard(self)

    def __repr__(self):
        state = "done" if self.done() else "in-flight"
        return f"QueryTicket({self.label!r}, {state})"


@dataclasses.dataclass
class ServiceStats:
    """Scheduler-level accounting (per-query accounting stays on the
    oracles / QueryResults, untouched by merging)."""
    merge: DispatchMergeStats = dataclasses.field(
        default_factory=DispatchMergeStats)
    n_submitted: int = 0
    n_deferred: int = 0          # tasks held back by an oracle conflict
    n_completed: int = 0
    n_failed: int = 0
    n_dispatch_ticks: int = 0    # barrier ticks that drained a batch

    def metrics_view(self) -> dict:
        """Unified-name view for ``MetricsRegistry.sync_from`` (includes
        the nested merge stats)."""
        view = self.merge.metrics_view()
        view.update({
            "service.submitted": self.n_submitted,
            "service.deferred": self.n_deferred,
            "service.completed": self.n_completed,
            "service.failed": self.n_failed,
            "service.dispatch_ticks": self.n_dispatch_ticks,
        })
        return view


def _map_leaves(expr: Expr, fn) -> Expr:
    """Rebuild an expression with every Pred leaf passed through ``fn``."""
    if isinstance(expr, Pred):
        return fn(expr)
    if isinstance(expr, Not):
        return Not(_map_leaves(expr.child, fn))
    if isinstance(expr, And):
        return And(*[_map_leaves(c, fn) for c in expr.children])
    if isinstance(expr, Or):
        return Or(*[_map_leaves(c, fn) for c in expr.children])
    raise TypeError(f"unknown Expr node {type(expr).__name__}")


class QueryScheduler:
    """Barrier-tick scheduler over one Session (see module docstring).

    Use through ``Session.submit()``/``gather()``; ``holding()`` pauses
    dispatch so a burst of submissions merges from its very first round:

        with sess.scheduler.holding():
            tickets = [sess.submit(q) for q in queries]
        results = sess.gather(*tickets)
    """

    def __init__(self, session, pipeline_depth: Optional[int] = None,
                 pack: bool = True, coordinator=None):
        self.session = session
        self.stats = ServiceStats()
        # tick-level pipelining: CSVConfig.pipeline_depth generalized to
        # the service layer.  Each barrier tick splits into up to this many
        # task-ordered waves queued back-to-back on the FIFO lane, so the
        # engine prefill of wave k+1 overlaps host-side voting/partitioning
        # by the task threads wave k just unparked.  Depth 1 == one merged
        # dispatch per tick (the PR-5 behavior).
        if pipeline_depth is None:
            pipeline_depth = max(1, getattr(getattr(session, "policy", None),
                                            "pipeline_depth", 1))
        self.pipeline_depth = int(pipeline_depth)
        # pack=False keeps per-oracle engine dispatch (benchmark control)
        self.pack = pack
        self._cv = threading.Condition()
        # observable idle flag: set while the scheduler has NO queries in
        # flight or deferred.  The loop thread parks on the condition (via
        # ``wait_for``) the whole time this is set — an idle scheduler
        # performs zero dispatch work (asserted in tests/test_torch_service.py),
        # which matters for an always-on stream watcher between ticks.
        self.idle = threading.Event()
        self.idle.set()
        self._running: List[_Task] = []
        self._deferred: List[_Task] = []
        self._tickets: List[QueryTicket] = []
        self._hold = 0
        self._closed = False
        self._next_index = 0
        # one FIFO lane for ALL queries' oracles: the merged dispatch
        # drains through it in deterministic (task, submission) order.
        # With a DispatchCoordinator the lane is shared across schedulers
        # (repro_torch.distributed.coordinator): waves still leave here in
        # this scheduler's submission order, so per-query bit-identity holds.
        if coordinator is not None:
            self._dispatcher = coordinator.attach()
        else:
            self._dispatcher = AsyncOracleDispatcher()
        self._loop_thread = threading.Thread(
            target=self._loop, daemon=True, name="csv-service-scheduler")
        self._loop_thread.start()

    # ------------------------------------------------------------- submit
    def submit(self, query, policy=None,
               label: Optional[str] = None) -> QueryTicket:
        """Schedule a query; returns immediately with a ticket.

        The query is cloned with every leaf oracle rebound to a batching
        proxy; the original query object stays collectable serially.
        Tasks whose oracles overlap an in-flight task are deferred until
        it finishes (submission order — serial semantics for the shared
        predicate, including memo replay)."""
        if getattr(query, "session", None) is not self.session:
            raise ValueError("query belongs to a different session")
        with self._cv:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            task = _Task(self._next_index,
                         label or f"q{self._next_index}", policy)
            self._next_index += 1
        task.query = self._instrument(task, query)
        ticket = QueryTicket(self, task)
        with self._cv:
            self.stats.n_submitted += 1
            self.idle.clear()
            self._tickets.append(ticket)
            blockers = set()
            for t in self._running + self._deferred:
                blockers |= t.oracle_ids
            if task.oracle_ids & blockers:
                task.deferred = True
                self.stats.n_deferred += 1
                self._deferred.append(task)
            else:
                self._start_locked(task)
            self._cv.notify_all()
        return ticket

    def _instrument(self, task: _Task, query):
        """Clone with proxied oracles (one proxy per distinct oracle)."""
        proxies: Dict[int, BatchingOracleProxy] = {}

        def proxy_for(oracle) -> BatchingOracleProxy:
            ident = oracle_identity(oracle)
            key = id(ident)
            if key not in proxies:
                proxies[key] = BatchingOracleProxy(self, task, oracle)
                task.oracle_refs.append(ident)
            return proxies[key]

        if isinstance(query, FilterQuery):
            expr = _map_leaves(
                query.expr,
                lambda p: Pred(p.name, proxy_for(p.oracle), p.cfg))
            clone = FilterQuery(self.session, query.handle, expr,
                                policy=query.policy, proxy=query.proxy)
            # share the pilot caches: a re-plan of the clone must reuse
            # probes the original already paid for (and vice versa), not
            # re-probe a memo-warm oracle — see FilterQuery._prepare
            clone._pilot_cache = query._pilot_cache
            clone._fresh_pilots = query._fresh_pilots
        elif isinstance(query, JoinQuery):
            clone = JoinQuery(self.session, query.left, query.right,
                              proxy_for(query.oracle), policy=query.policy)
        else:
            raise TypeError(
                f"cannot schedule {type(query).__name__}; expected a "
                "FilterQuery or JoinQuery")
        task.oracle_ids = frozenset(id(o) for o in task.oracle_refs)
        return clone

    def _start_locked(self, task: _Task) -> None:
        self._running.append(task)
        task.thread = threading.Thread(
            target=self._run_task, args=(task,), daemon=True,
            name=f"csv-service-{task.label}")
        task.thread.start()

    def _run_task(self, task: _Task) -> None:
        try:
            result = task.query.collect(task.policy)
        except BaseException as e:
            failed = True
            task.future.set_exception(e)
        else:
            failed = False
            task.future.set_result(result)
        finally:
            with self._cv:
                task.finished = True
                self._running.remove(task)
                while task.pending:  # defensive: never strand a waiter
                    task.pending.popleft().future.set_exception(
                        RuntimeError("task exited with unserved oracle "
                                     "requests"))
                if failed:
                    self.stats.n_failed += 1
                else:
                    self.stats.n_completed += 1
                self._release_deferred_locked()
                if not self._running and not self._deferred:
                    self.idle.set()
                self._cv.notify_all()

    def _release_deferred_locked(self) -> None:
        """Start every deferred task whose oracles no longer conflict.
        Order is preserved: a deferred task also blocks later tasks that
        overlap it, so conflicting tasks always run in submission order."""
        blockers = set()
        for t in self._running:
            blockers |= t.oracle_ids
        still: List[_Task] = []
        for t in self._deferred:
            if t.oracle_ids & blockers:
                still.append(t)
            else:
                self._start_locked(t)
            blockers |= t.oracle_ids
        self._deferred = still

    # ------------------------------------------------------------ requests
    def _evaluate(self, task: _Task, oracle, ids) -> np.ndarray:
        """Proxy entry point: park the calling thread until the merged
        dispatch containing this batch resolves."""
        req = _OracleRequest(task=task, oracle=oracle,
                             ids=np.asarray(ids), future=Future(),
                             span=get_tracer().current())
        with self._cv:
            task.pending.append(req)
            self._cv.notify_all()
        return req.future.result()

    def _barrier_ready_locked(self) -> bool:
        """``wait_for`` predicate for the loop thread (call under _cv).
        True when the loop has something to do: shut down, or dispatch a
        full barrier tick.  While idle the thread blocks in ``_cv.wait``
        inside ``wait_for`` — it burns no CPU and ticks no dispatch work
        until a submit/park/close notifies the condition."""
        if self._closed and not self._running and not self._deferred:
            return True
        if (self._hold == 0 and self._running
                and all(t.pending for t in self._running)):
            return True
        if not self._running and not self._deferred:
            self.idle.set()
        return False

    def _loop(self) -> None:
        while True:
            with self._cv:
                self._cv.wait_for(self._barrier_ready_locked)
                if (self._closed and not self._running
                        and not self._deferred):
                    return
                self.stats.n_dispatch_ticks += 1
                batch: List[_OracleRequest] = []
                for t in sorted(self._running, key=lambda t: t.index):
                    while t.pending:
                        batch.append(t.pending.popleft())
            # evaluate OUTSIDE the lock: split the tick into up to
            # pipeline_depth task-ordered waves, each ONE packed dispatch
            # on the FIFO lane — oracles sharing an engine contribute all
            # their prompts to a single bucketed first_token_logits call
            # per wave, and wave k+1's prefill overlaps the voting wave k
            # unparked (see _run_wave)
            n_waves = max(1, min(self.pipeline_depth, len(batch)))
            bounds = np.linspace(0, len(batch), n_waves + 1).astype(int)
            for w in range(n_waves):
                wave = batch[bounds[w]:bounds[w + 1]]
                if wave:
                    self._dispatcher.submit_call(self._run_wave, wave)

    def _run_wave(self, wave: List[_OracleRequest]) -> None:
        """Evaluate one packed wave on the dispatcher lane and unpark its
        requesters.  Runs strictly FIFO relative to other waves, so
        per-oracle evaluation order stays exactly submission order."""
        tr = get_tracer()
        t0 = monotonic()
        # the wave runs on the lane thread; parent it to the first
        # requester's captured span (the cross-thread edge) and list every
        # member request's span id so all requesters stay correlated
        with tr.span("dispatch_wave", kind="dispatch_wave",
                     parent=wave[0].span,
                     n_requests=len(wave),
                     n_ids=int(sum(len(r.ids) for r in wave)),
                     tasks=[r.task.label for r in wave],
                     request_spans=[getattr(r.span, "span_id", None)
                                    for r in wave]) as sp:
            try:
                outcomes, info = evaluate_packed(
                    [(r.oracle, r.ids) for r in wave], pack=self.pack)
            except BaseException as e:  # defensive: never strand a waiter
                outcomes, info = [e] * len(wave), {"tokens": 0,
                                                   "truncated": 0}
            sp.set(tokens=info["tokens"], truncated=info["truncated"])
        wall = monotonic() - t0
        self.stats.merge.record([len(r.ids) for r in wave],
                                wall_s=wall,
                                tokens=info["tokens"],
                                truncated=info["truncated"])
        tr.metrics.inc("service.ticks")
        tr.metrics.observe("service.wave_wall_s", wall)
        tr.metrics.set("service.batch_fill", self.stats.merge.merge_factor)
        # the dispatch tick is the service's natural heartbeat: evaluate
        # health rules here (rate-limited inside; no-op null default)
        get_monitor().maybe_evaluate()
        for r, out in zip(wave, outcomes):
            if isinstance(out, BaseException):
                r.future.set_exception(out)
            else:
                r.future.set_result(out)

    # ------------------------------------------------------------- status
    def status_view(self) -> dict:
        """statusz section: in-flight work and lifetime tick counters."""
        with self._cv:
            in_flight = len(self._running)
            deferred = len(self._deferred)
        return {
            "in_flight": in_flight,
            "deferred": deferred,
            "idle": self.idle.is_set(),
            "submitted": self.stats.n_submitted,
            "completed": self.stats.n_completed,
            "failed": self.stats.n_failed,
            "dispatch_ticks": self.stats.n_dispatch_ticks,
            "mean_batch_size": self.stats.merge.mean_batch_size,
            "merge_factor": self.stats.merge.merge_factor,
        }

    # ------------------------------------------------------------ control
    @contextlib.contextmanager
    def holding(self):
        """Pause dispatch while submitting a burst, so even first-round
        batches merge across the whole burst (deterministic merge sizes)."""
        with self._cv:
            self._hold += 1
        try:
            yield self
        finally:
            with self._cv:
                self._hold = max(0, self._hold - 1)
                self._cv.notify_all()

    def _discard(self, ticket: QueryTicket) -> None:
        """Drop a consumed ticket from the bookkeeping — a long-lived
        service must not retain every ticket (and its result mask) ever
        served."""
        with self._cv:
            ticket._gathered = True
            self._tickets = [t for t in self._tickets if t is not ticket]

    def take_outstanding(self, *tickets) -> List[QueryTicket]:
        """Claim tickets for gathering: select the given tickets (or every
        not-yet-gathered one), mark them gathered, and drop them from the
        scheduler's bookkeeping.  Raises — instead of claiming and then
        deadlocking — when dispatch is held and a selected ticket is still
        in flight; NOT releasing the hold here is deliberate: another
        thread may be mid-``holding()`` building its own burst, and its
        merge guarantee must survive a concurrent gather."""
        with self._cv:
            targets = list(tickets) if tickets else [
                t for t in self._tickets if not t._gathered]
            if self._hold > 0 and any(not t.done() for t in targets):
                raise RuntimeError(
                    "gather() inside scheduler.holding() would wait "
                    "forever (dispatch is paused); exit the holding() "
                    "block first")
            for tk in targets:
                tk._gathered = True
            self._tickets = [t for t in self._tickets if not t._gathered]
        return targets

    def gather(self, *tickets):
        """Wait for the given tickets (all outstanding ones when called
        with no arguments) and return their results in order."""
        return [tk.result() for tk in self.take_outstanding(*tickets)]

    def close(self) -> None:
        """Drain in-flight tasks and stop the scheduler threads."""
        with self._cv:
            self._closed = True
            self._hold = 0
            self._cv.notify_all()
        self._loop_thread.join()
        self._dispatcher.close()
