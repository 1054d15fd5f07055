"""Health monitors: declarative alert rules over the metrics registry.

A ``HealthRule`` is one threshold over the registry snapshot — either a
dotted metric name (histograms resolve to their mean) or an arbitrary
``value_fn`` deriving a number from the whole snapshot (ratios, deltas).
``HealthMonitor.evaluate()`` runs every rule and routes **edge-triggered**
alerts to pluggable sinks: a rule fires exactly once when it crosses into
breach, stays silent while the breach persists, and emits one ``recover``
alert when it crosses back — so a flapping metric cannot flood the sinks.

The monitor is evaluated from the hot loops' natural heartbeat — the
service scheduler's barrier tick and the stream watcher's tick — through
the ambient ``get_monitor()`` hook, whose default is a no-op null monitor
(same pattern as ``repro_torch.obs.trace.get_tracer``): an uninstrumented run
pays one module-global read per tick and nothing else.

Critical alerts additionally invoke ``on_critical`` (the flight recorder
registers its dump there; docs/observability.md).
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.utils.timing import monotonic

SEVERITIES = ("info", "warning", "critical")


@dataclasses.dataclass
class Alert:
    """One edge-triggered rule transition (breach or recovery)."""
    rule: str
    severity: str
    kind: str                  # "breach" | "recover"
    value: Optional[float]
    threshold: float
    message: str
    wall_time: float

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        v = "n/a" if self.value is None else f"{self.value:g}"
        return (f"[{self.severity}] {self.rule} {self.kind}: value={v} "
                f"threshold={self.threshold:g} — {self.message}")


def _metric_value(snapshot: Dict[str, Any], name: str) -> Optional[float]:
    """Scalar view of one snapshot entry; histograms read as their mean."""
    v = snapshot.get(name)
    if v is None:
        return None
    if isinstance(v, dict):
        v = v.get("mean")
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


def ratio(num: str, den: Sequence[str]) -> Callable[[Dict[str, Any]],
                                                    Optional[float]]:
    """value_fn: ``num / sum(den)`` over the snapshot; None until den > 0."""
    def fn(snapshot: Dict[str, Any]) -> Optional[float]:
        n = _metric_value(snapshot, num)
        d = sum(_metric_value(snapshot, k) or 0.0 for k in den)
        if n is None or d <= 0:
            return None
        return n / d
    return fn


def counter_delta(total: str, mark: str) -> Callable[[Dict[str, Any]],
                                                     Optional[float]]:
    """value_fn: ``total - mark`` (e.g. WAL bytes since last compaction)."""
    def fn(snapshot: Dict[str, Any]) -> Optional[float]:
        t = _metric_value(snapshot, total)
        if t is None:
            return None
        return t - (_metric_value(snapshot, mark) or 0.0)
    return fn


@dataclasses.dataclass
class HealthRule:
    """One declarative threshold.

    metric: dotted registry name (histograms -> mean), or None when
    ``value_fn`` derives the value from the full snapshot.  ``op`` is the
    breach direction: ``">"`` fires when value > threshold, ``"<"`` when
    value < threshold.  A rule whose value is unavailable (metric absent,
    denominator zero, fewer than ``min_count`` histogram observations)
    never fires.
    """
    name: str
    threshold: float
    metric: Optional[str] = None
    value_fn: Optional[Callable[[Dict[str, Any]], Optional[float]]] = None
    op: str = ">"
    severity: str = "warning"
    message: str = ""
    min_count: int = 0         # histogram metrics: required observations

    def __post_init__(self):
        if (self.metric is None) == (self.value_fn is None):
            raise ValueError(f"rule {self.name!r}: exactly one of metric/"
                             "value_fn must be set")
        if self.op not in (">", "<"):
            raise ValueError(f"rule {self.name!r}: op must be '>' or '<'")
        if self.severity not in SEVERITIES:
            raise ValueError(f"rule {self.name!r}: severity must be one of "
                             f"{SEVERITIES}")

    def current(self, snapshot: Dict[str, Any]) -> Optional[float]:
        if self.value_fn is not None:
            return self.value_fn(snapshot)
        raw = snapshot.get(self.metric)
        if (self.min_count and isinstance(raw, dict)
                and raw.get("count", 0) < self.min_count):
            return None
        return _metric_value(snapshot, self.metric)

    def breached(self, value: Optional[float]) -> bool:
        if value is None:
            return False
        return value > self.threshold if self.op == ">" else \
            value < self.threshold


# -------------------------------------------------------------- alert sinks
class LogAlertSink:
    """Prints alerts to stdout with an optional prefix (CLI default)."""

    def __init__(self, prefix: str = "[health]"):
        self.prefix = prefix

    def __call__(self, alert: Alert) -> None:
        print(f"{self.prefix} {alert}")


class JsonlAlertSink:
    """Appends one JSON object per alert to a file."""

    def __init__(self, path):
        self.path = pathlib.Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def __call__(self, alert: Alert) -> None:
        with self.path.open("a") as f:
            f.write(json.dumps(alert.to_dict(), sort_keys=True) + "\n")


class CallbackAlertSink:
    """Routes alerts to an arbitrary callable (tests, pagers, queues)."""

    def __init__(self, fn: Callable[[Alert], None]):
        self.fn = fn

    def __call__(self, alert: Alert) -> None:
        self.fn(alert)


# ------------------------------------------------------------- the monitor
class HealthMonitor:
    """Evaluates rules over one registry and routes edge-triggered alerts."""

    enabled = True

    def __init__(self, registry, rules: Sequence[HealthRule] = (),
                 sinks: Sequence[Callable[[Alert], None]] = (),
                 min_interval_s: float = 1.0,
                 on_critical: Optional[Callable[[Alert], None]] = None,
                 recent_capacity: int = 64):
        self.registry = registry
        self.rules: List[HealthRule] = list(rules)
        self.sinks: List[Callable[[Alert], None]] = list(sinks)
        self.min_interval_s = float(min_interval_s)
        self.on_critical = on_critical
        self._firing: Dict[str, bool] = {}
        self._recent: deque = deque(maxlen=recent_capacity)
        self._last_eval = float("-inf")
        self._lock = threading.Lock()

    # -------------------------------------------------------- configuration
    def add_rule(self, rule: HealthRule) -> "HealthMonitor":
        self.rules.append(rule)
        return self

    def add_sink(self, sink: Callable[[Alert], None]) -> "HealthMonitor":
        self.sinks.append(sink)
        return self

    # ------------------------------------------------------------ queries
    def firing(self) -> Dict[str, bool]:
        with self._lock:
            return dict(self._firing)

    def recent(self, n: int = 20) -> List[Alert]:
        with self._lock:
            return list(self._recent)[-n:]

    def status(self) -> Dict[str, Any]:
        """healthz view: overall status + what is firing right now."""
        firing = {k for k, v in self.firing().items() if v}
        sev = {r.name: r.severity for r in self.rules}
        critical = any(sev.get(name) == "critical" for name in firing)
        return {
            "status": ("critical" if critical
                       else "degraded" if firing else "ok"),
            "firing": sorted(firing),
            "rules": len(self.rules),
        }

    # ---------------------------------------------------------- evaluation
    def maybe_evaluate(self) -> List[Alert]:
        """Rate-limited evaluate() — the tick-loop entry point."""
        now = monotonic()
        with self._lock:
            if now - self._last_eval < self.min_interval_s:
                return []
            self._last_eval = now
        return self.evaluate()

    def evaluate(self) -> List[Alert]:
        snapshot = self.registry.snapshot()
        alerts: List[Alert] = []
        for rule in self.rules:
            value = rule.current(snapshot)
            breach = rule.breached(value)
            with self._lock:
                was = self._firing.get(rule.name, False)
                self._firing[rule.name] = breach
            if breach == was:
                continue  # edge-triggered: steady state is silent
            alert = Alert(
                rule=rule.name, severity=rule.severity,
                kind="breach" if breach else "recover", value=value,
                threshold=rule.threshold,
                message=rule.message or rule.name,
                wall_time=time.time())  # noqa: TID251 — operator-facing
            alerts.append(alert)
        if alerts:
            with self._lock:
                self._recent.extend(alerts)
            metrics = self.registry
            for alert in alerts:
                metrics.inc("health.alerts")
                for sink in self.sinks:
                    try:
                        sink(alert)
                    except Exception as e:  # a broken pager must not
                        print(f"[health] sink failed: {e!r}")  # kill ticks
                if (alert.kind == "breach" and alert.severity == "critical"
                        and self.on_critical is not None):
                    try:
                        self.on_critical(alert)
                    except Exception as e:
                        print(f"[health] on_critical failed: {e!r}")
        self.registry.inc("health.evaluations")
        return alerts


class _NullMonitor:
    """Ambient default: absorbs tick hooks at zero cost."""

    enabled = False
    rules: List[HealthRule] = []

    def maybe_evaluate(self):
        return []

    def evaluate(self):
        return []

    def recent(self, n: int = 20):
        return []

    def firing(self):
        return {}

    def status(self):
        return {"status": "ok", "firing": [], "rules": 0}


NULL_MONITOR = _NullMonitor()
_active = NULL_MONITOR


def get_monitor():
    return _active


def set_monitor(monitor) -> None:
    """Install the process-wide monitor (None restores the null default)."""
    global _active
    _active = monitor if monitor is not None else NULL_MONITOR


# ------------------------------------------------------------ default rules
def default_rules() -> List[HealthRule]:
    """The operational rule set the CLIs install (docs/observability.md).

    Thresholds are deliberately conservative defaults — every rule is a
    plain dataclass, so deployments tune or replace them freely.
    """
    return [
        HealthRule(
            name="vote-margin-collapse", metric="quality.vote_margin",
            op="<", threshold=0.02, min_count=8, severity="warning",
            message="mean cluster vote margin is hugging the decision "
                    "band; votes are barely decided"),
        HealthRule(
            name="memo-hit-rate-drop",
            value_fn=ratio("oracle.cached", ("oracle.calls",
                                             "oracle.cached")),
            op="<", threshold=0.05, severity="info",
            message="session memo is answering <5% of oracle traffic"),
        HealthRule(
            name="tenant-budget-burn",
            metric="service.tenant_budget_used_ratio",
            op=">", threshold=0.9, severity="critical",
            message="a tenant has burned >90% of its admission budget"),
        HealthRule(
            name="sink-dead-letters",
            value_fn=ratio("sink.dead_lettered", ("sink.delivered",
                                                  "sink.dead_lettered")),
            op=">", threshold=0.01, severity="critical",
            message="stream notifications are dead-lettering"),
        HealthRule(
            name="stream-tick-lag", metric="stream.tick_lag_rows",
            op=">", threshold=500.0, severity="warning",
            message="the stream source is deferring rows faster than "
                    "ticks drain them"),
        HealthRule(
            name="wal-growth",
            value_fn=counter_delta("log.bytes",
                                   "log.last_compaction_bytes"),
            op=">", threshold=float(16 << 20), severity="warning",
            message="session WAL grew >16 MiB since the last compaction"),
        HealthRule(
            name="stream-centroid-drift", metric="stream.centroid_drift",
            op=">", threshold=0.5, severity="warning",
            message="incoming rows have drifted from the frozen stream "
                    "centroids; consider reclustering"),
    ]
