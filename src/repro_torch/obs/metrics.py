"""MetricsRegistry: one naming scheme over the stack's scattered stats.

The execution layers each kept their own counters — ``OracleStats`` (calls,
tokens, batch sizes), ``DispatchMergeStats`` (merged-dispatch fill/wall),
``ServiceStats`` (submit/defer/complete), ``ServingEngine.stats`` and
``BucketBatcher.stats`` (device batches, padding fill, truncation).  Those
dataclasses REMAIN the per-object accounting of record (bit-compatibility:
nothing about their delta/clone/merge semantics changes); this registry is
the unified, exportable aggregate over them:

- live instrumentation (tracer-gated) bumps counters/histograms as a side
  effect of execution — ``oracle.calls``, ``engine.prefill_tokens``,
  ``memo.replays``, ``round.wall_s``, ...;
- ``sync_from`` absorbs a stats object through its ``metrics_view()``
  (added to each legacy dataclass) so end-of-run dumps carry the full
  unified picture even for counters with no live hook.

Three instrument kinds, all O(1) memory:

- ``Counter``: monotonically increasing float (calls, tokens).
- ``Gauge``: last-set value (fill ratios, means) + ``info`` string gauges
  (``kernel.attn_impl``) rendered Prometheus-style as ``name{value="x"} 1``.
- ``Histogram``: fixed bucket bounds; observations update per-bucket counts
  and count/sum/min/max only — 10k observations occupy exactly the same
  memory as 10 (asserted in tests/test_obs.py).

``NULL_REGISTRY`` is the disabled no-op twin the ``NullTracer`` exposes, so
hot paths publish unconditionally without branching.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

# default histogram bounds: log-ish spacing covering micro-batches (1-1e5
# ids) and sub-ms..minutes wall times once scaled; callers with a better
# idea pass bounds= at first observe()
DEFAULT_BOUNDS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                  50.0, 100.0, 500.0, 1000.0, 5000.0, 10000.0)


class Counter:
    __slots__ = ("name", "value")
    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Gauge:
    __slots__ = ("name", "value")
    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.value: Any = 0.0

    def set(self, v) -> None:
        self.value = v


class Histogram:
    """Bounded histogram: fixed buckets, O(1) per observation, O(1) memory."""

    __slots__ = ("name", "bounds", "counts", "count", "sum", "min", "max")
    kind = "histogram"

    def __init__(self, name: str, bounds: Tuple[float, ...] = DEFAULT_BOUNDS):
        self.name = name
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError(f"histogram bounds must be sorted: {bounds}")
        self.counts = [0] * (len(self.bounds) + 1)  # +1 = +Inf bucket
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        lo, hi = 0, len(self.bounds)
        while lo < hi:  # bisect: first bound >= v
            mid = (lo + hi) // 2
            if self.bounds[mid] < v:
                lo = mid + 1
            else:
                hi = mid
        self.counts[lo] += 1
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class MetricsRegistry:
    """Name -> instrument map with create-on-first-use accessors."""

    enabled = True

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}
        self._info: Dict[str, str] = {}

    def _get(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.setdefault(name, cls(name, *args))
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, not {cls.kind}")
        return m

    # ----------------------------------------------------------- accessors
    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  bounds: Tuple[float, ...] = DEFAULT_BOUNDS) -> Histogram:
        return self._get(name, Histogram, bounds)

    # ---------------------------------------------------------- shorthands
    def inc(self, name: str, v: float = 1.0) -> None:
        self.counter(name).inc(v)

    def set(self, name: str, v) -> None:
        self.gauge(name).set(v)

    def observe(self, name: str, v: float,
                bounds: Tuple[float, ...] = DEFAULT_BOUNDS) -> None:
        self.histogram(name, bounds).observe(v)

    def set_info(self, name: str, value: str) -> None:
        """String-valued gauge (Prometheus info idiom)."""
        with self._lock:
            self._info[name] = str(value)

    # -------------------------------------------------------------- absorb
    def sync_from(self, *stats_objects, prefix: str = "") -> None:
        """Absorb legacy stats dataclasses through their ``metrics_view()``:
        counters/gauges land under the unified names (counter values are
        SET, not added — a view reflects the object's current totals)."""
        for obj in stats_objects:
            if obj is None:
                continue
            view = obj.metrics_view() if hasattr(obj, "metrics_view") \
                else dict(obj)
            for name, value in view.items():
                full = prefix + name
                if isinstance(value, str):
                    self.set_info(full, value)
                elif name.endswith(tuple(_GAUGE_SUFFIXES)):
                    self.set(full, float(value))
                else:
                    self.counter(full).value = float(value)

    # -------------------------------------------------------------- export
    def snapshot(self) -> Dict[str, Any]:
        """Plain-dict view (JSON-ready) of every instrument."""
        with self._lock:
            metrics = dict(self._metrics)
            info = dict(self._info)
        out: Dict[str, Any] = {}
        for name, m in sorted(metrics.items()):
            if isinstance(m, Histogram):
                out[name] = {
                    "count": m.count, "sum": m.sum, "mean": m.mean,
                    "min": (None if m.count == 0 else m.min),
                    "max": (None if m.count == 0 else m.max),
                    "buckets": dict(zip([*map(str, m.bounds), "+Inf"],
                                        m.counts))}
            else:
                out[name] = m.value
        for name, v in sorted(info.items()):
            out[name] = v
        return out

    def _iter_instruments(self) -> Iterable:
        with self._lock:
            yield from sorted(self._metrics.items())

    def _iter_info(self) -> List[Tuple[str, str]]:
        with self._lock:
            return sorted(self._info.items())


# names carrying a point-in-time reading (means/ratios/rates) sync as gauges
_GAUGE_SUFFIXES = ("_ratio", "_per_s", "mean_batch_size", "merge_factor",
                   "fill", "last_invocation", "last_wall_s")


class NullRegistry:
    """No-op registry: the disabled-observability fast path."""

    enabled = False

    def counter(self, name):
        return _NULL_INSTRUMENT

    def gauge(self, name):
        return _NULL_INSTRUMENT

    def histogram(self, name, bounds=DEFAULT_BOUNDS):
        return _NULL_INSTRUMENT

    def inc(self, name, v=1.0):
        pass

    def set(self, name, v):
        pass

    def observe(self, name, v, bounds=DEFAULT_BOUNDS):
        pass

    def set_info(self, name, value):
        pass

    def sync_from(self, *stats_objects, prefix=""):
        pass

    def snapshot(self):
        return {}


class _Null:
    __slots__ = ()

    def inc(self, v=1.0):
        pass

    def set(self, v):
        pass

    def observe(self, v):
        pass


_NULL_INSTRUMENT = _Null()
NULL_REGISTRY = NullRegistry()
