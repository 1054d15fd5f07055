"""Hierarchical tracing: end-to-end spans across every execution layer.

One query produces one span tree —

    query                      Query.collect (filter / join / baseline)
      plan_node                PlanExecutor per executed leaf
        round                  CSV driver re-clustering round (or join round)
          plan                 sample planning (RNG draws)
          oracle               oracle submit + wait (per wave)
          vote                 segmented voting dispatch + application
          partition            recluster-or-fallback tail
    dispatch_wave              QueryScheduler._run_wave (cross-query merge;
                               parented to the requesting oracle span)
      engine_tick              ServingEngine per bucketed device batch
        attn|mamba|moe|mlp     one layer of that kind (kind "layer")

The port adds leaves of its own (``PORT_ONLY_KINDS``), which the JAX
reference does not open: the driver's host steps (kind ``"step"``:
``gather_rows``, ``vote_pack``, ``to_device`` under ``vote`` and
``partition``; ``kmeans_seed`` and ``kmeans_lloyd`` wherever k-means
runs) and the model's layer kinds above.

Span ids are stable small integers assigned in creation order under one
lock, so a deterministic run yields a deterministic id assignment.  The
*current* span is thread-local (``contextvars``): spans opened on one
thread nest automatically; cross-thread edges (task thread -> scheduler
dispatch lane) are drawn explicitly by capturing ``tracer.current()`` into
the request and passing it as ``parent=``.

The module-global active tracer defaults to ``NULL_TRACER`` whose ``span``
is a no-op returning a shared singleton — instrumented hot paths pay one
attribute lookup and a no-op call when tracing is disabled, and notably
never build per-span state.  Enable with ``set_tracer(Tracer())`` or the
``use_tracer`` context manager.  Bit-identity: tracing only *observes*
(clocks + counters); it never touches an RNG stream, an oracle memo, or a
device dispatch, so traced and untraced runs produce identical masks and
call counts (asserted in tests/test_obs.py).
"""
from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.obs.metrics import NULL_REGISTRY, MetricsRegistry
from repro_torch.utils.timing import monotonic

# span kinds the port opens and the JAX reference does not: the parity
# tests leave out exactly these before comparing span trees
PORT_ONLY_KINDS = ("step", "layer")

_current: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_obs_current_span", default=None)


class Span:
    """One timed, attributed node of the trace tree."""

    __slots__ = ("span_id", "parent_id", "name", "kind", "t0", "t1",
                 "attrs", "thread")

    def __init__(self, span_id: int, parent_id: Optional[int], name: str,
                 kind: str, attrs: Dict[str, Any]):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.kind = kind
        self.t0 = 0.0
        self.t1: Optional[float] = None
        self.attrs = attrs
        self.thread = threading.current_thread().name

    def set(self, **attrs) -> "Span":
        """Attach/overwrite attributes (e.g. results known only at exit)."""
        self.attrs.update(attrs)
        return self

    @property
    def duration_s(self) -> float:
        return (self.t1 if self.t1 is not None else monotonic()) - self.t0

    def to_dict(self) -> Dict[str, Any]:
        return {"span_id": self.span_id, "parent_id": self.parent_id,
                "name": self.name, "kind": self.kind, "t0": self.t0,
                "dur_s": (None if self.t1 is None else self.t1 - self.t0),
                "thread": self.thread, "attrs": dict(self.attrs)}

    def __repr__(self):
        return (f"Span({self.span_id}, {self.name!r}, "
                f"parent={self.parent_id})")


class _SpanCtx:
    """Context manager entering/exiting one span (one per ``Tracer.span``)."""

    __slots__ = ("_tracer", "_span", "_token")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span
        self._token = None

    def __enter__(self) -> Span:
        self._span.t0 = monotonic()
        self._token = _current.set(self._span)
        return self._span

    def __exit__(self, *exc) -> bool:
        self._span.t1 = monotonic()
        _current.reset(self._token)
        return False


class _NullSpan:
    """Shared do-nothing span: the disabled-tracing fast path."""

    __slots__ = ()
    span_id = None
    parent_id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every operation is a no-op (the ambient default).

    ``metrics`` is the no-op registry, so instrumented code can publish
    unconditionally (``tracer.metrics.inc(...)``) without branching."""

    enabled = False
    metrics = NULL_REGISTRY

    def span(self, name, kind: str = "span", parent=None, **attrs):
        return NULL_SPAN

    def current(self):
        return None

    def spans(self):
        return []


NULL_TRACER = NullTracer()


class Tracer:
    """Collecting tracer: builds the span tree and feeds a MetricsRegistry.

    Spans are appended (under a lock) at *entry*, so a crashed run still
    shows what was in flight (``t1 is None``).  ``epoch_wall``/``epoch_mono``
    pin the monotonic timeline to a wall-clock instant for exports.
    """

    enabled = True

    def __init__(self, metrics: Optional[MetricsRegistry] = None):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.epoch_wall = time.time()  # noqa: TID251 — wall anchor for export
        self.epoch_mono = monotonic()
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._next_id = 1

    def span(self, name: str, kind: str = "span", parent=None,
             **attrs) -> _SpanCtx:
        """Open a span as a context manager yielding the ``Span``.

        ``parent`` overrides the thread-local current span — the explicit
        cross-thread edge (scheduler wave -> requesting oracle span).  It
        accepts a ``Span``, a span id, or None (root).
        """
        if parent is None:
            cur = _current.get()
            parent_id = None if cur is None else cur.span_id
        elif isinstance(parent, Span):
            parent_id = parent.span_id
        else:
            parent_id = int(parent)
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            sp = Span(sid, parent_id, name, kind, attrs)
            self._spans.append(sp)
        return _SpanCtx(self, sp)

    def current(self) -> Optional[Span]:
        """The innermost open span on THIS thread (None outside any span)."""
        return _current.get()

    def spans(self) -> List[Span]:
        """Snapshot of all spans in creation order (open spans included)."""
        with self._lock:
            return list(self._spans)

    # ------------------------------------------------------------- export
    def export_jsonl(self, path) -> int:
        from repro_torch.obs.export import write_spans_jsonl
        return write_spans_jsonl(self.spans(), path)

    def export_perfetto(self, path) -> int:
        from repro_torch.obs.export import write_perfetto
        return write_perfetto(self.spans(), path, epoch_mono=self.epoch_mono)


# ------------------------------------------------------------- clock anchor
def clock_anchor(tries: int = 5) -> tuple:
    """(``perf_counter_ns``, ``time_ns``) read back to back: the narrowest
    of ``tries`` reads, the monotonic reading taken at the middle of the
    pair's bracket."""
    best = None
    for _ in range(tries):
        a = time.perf_counter_ns()
        w = time.time_ns()  # the unix-epoch clock torch.profiler stamps on
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, w)
    return best[1], best[2]


IMPORT_ANCHOR = clock_anchor()


def epoch_ns(t):
    """A ``monotonic()`` reading (seconds; a scalar or a numpy array) on
    the unix-epoch nanosecond clock that ``torch.profiler`` stamps its
    events on.  Interpolates linearly between the anchor taken at import
    and one taken now, so the two clocks' slew in between is taken out.

    To overlay a run's spans on its device trace::

        tr = Tracer()
        with torch.profiler.profile(activities=[CPU, CUDA]) as prof:
            with use_tracer(tr):
                query.collect()
        events = prof.profiler.kineto_results.events()
        spans = [(s.name, epoch_ns(s.t0), epoch_ns(s.t1))
                 for s in tr.spans()]

    A kernel (an event of device type CUDA that is not a mirror of a
    ``record_function`` range, ``is_user_annotation()``) shares its
    ``correlation_id()`` with the host call that launched it, the host
    event named ``cu*`` (``cudaLaunchKernel``, ``cuLaunchKernel``, ...;
    CPU operators number their own correlation ids, which can collide,
    and the events carry no activity type to tell them apart).  That
    launch's ``start_ns()`` lies inside the span that launched the kernel:
    ``bench/benchkit/attribution.py`` sums device time by layer kind so.
    """
    m0, w0 = IMPORT_ANCHOR
    m1, w1 = clock_anchor()
    rate = (w1 - w0) / (m1 - m0) if m1 > m0 else 1.0
    d = np.rint((np.asarray(t, np.float64) * 1e9 - m0) * rate)
    out = w0 + d.astype(np.int64)  # int64 keeps the epoch's nanoseconds
    return int(out) if out.ndim == 0 else out


# ------------------------------------------------------------ active tracer
_active: Any = NULL_TRACER


def get_tracer():
    """The ambient tracer every instrumented layer reads (one global so the
    CSV driver, engine, and scheduler threads all agree)."""
    return _active


def set_tracer(tracer) -> None:
    """Install ``tracer`` (or ``None``/``NULL_TRACER`` to disable)."""
    global _active
    _active = tracer if tracer is not None else NULL_TRACER


@contextlib.contextmanager
def use_tracer(tracer):
    """Scoped ``set_tracer``: restores the previous tracer on exit."""
    global _active
    prev = _active
    _active = tracer if tracer is not None else NULL_TRACER
    try:
        yield tracer
    finally:
        _active = prev
