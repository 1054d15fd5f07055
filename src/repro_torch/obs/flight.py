"""Flight recorder: a crash-time debug bundle for long-running processes.

Keeps a bounded window of recent activity — the tail of the tracer's span
list plus periodic metric *deltas* (what moved since the last heartbeat)
— and dumps a ``debug-bundle/`` directory when the process dies badly:

- **unhandled exception** — ``install()`` chains ``sys.excepthook``;
- **fatal signal** — registered with the existing
  ``repro_torch.service.lifecycle.GracefulShutdown`` (the dump only fires when
  a signal actually triggered the shutdown, never on a clean exit);
- **critical alert** — the health monitor's ``on_critical`` hook.

The bundle is small, self-contained, and parseable offline:

    debug-bundle/
      manifest.json       reason, wall time, exception/signal, file inventory
      spans.jsonl         the span ring (same schema as --trace-dir output)
      metrics.json        full registry snapshot at dump time
      metric_deltas.jsonl one line per heartbeat: counters that moved
      policy.json         execution-policy fingerprint (when attached)
      wal.json            session-log tail summary (when attached)
      alerts.jsonl        recent health alerts (when a monitor is attached)

Dumping is observation-only and idempotent per reason: re-dumps overwrite
in place, so the newest crash context wins.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, List, Optional

from repro_torch.obs.export import _jsonable, write_spans_jsonl
from repro_torch.obs.trace import get_tracer


class FlightRecorder:
    """Bounded recent-activity window + crash-time bundle writer."""

    def __init__(self, bundle_dir="debug-bundle", tracer=None, registry=None,
                 span_capacity: int = 512, delta_capacity: int = 128):
        self.bundle_dir = pathlib.Path(bundle_dir)
        self._tracer = tracer
        self._registry = registry
        self.span_capacity = int(span_capacity)
        self._deltas: deque = deque(maxlen=int(delta_capacity))
        self._alerts: deque = deque(maxlen=64)
        self._last_snap: Dict[str, float] = {}
        self._policy = None
        self._log_store = None
        self._lock = threading.Lock()
        self._prev_excepthook = None
        self.dumps = 0

    # ----------------------------------------------------------- plumbing
    @property
    def tracer(self):
        return self._tracer if self._tracer is not None else get_tracer()

    @property
    def registry(self):
        return (self._registry if self._registry is not None
                else self.tracer.metrics)

    def attach_policy(self, policy) -> "FlightRecorder":
        self._policy = policy
        return self

    def attach_log(self, log_store) -> "FlightRecorder":
        self._log_store = log_store
        return self

    # ---------------------------------------------------------- heartbeat
    def record_delta(self) -> Dict[str, float]:
        """One heartbeat: record which scalar metrics moved since the last
        call.  Cheap (one snapshot + dict diff) — call it from the same
        tick loop that evaluates health rules."""
        snap = self.registry.snapshot()
        flat: Dict[str, float] = {}
        for k, v in snap.items():
            if isinstance(v, dict):
                v = v.get("count")
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            flat[k] = float(v)
        with self._lock:
            delta = {k: v - self._last_snap.get(k, 0.0)
                     for k, v in flat.items()
                     if v != self._last_snap.get(k, 0.0)}
            self._last_snap = flat
            if delta:
                self._deltas.append(
                    {"wall_time": time.time(),  # noqa: TID251 — postmortem
                     "delta": delta})
        return delta

    def note_alert(self, alert) -> None:
        """Health-monitor hook: remember the alert; dump on critical."""
        with self._lock:
            self._alerts.append(alert)
        if (getattr(alert, "severity", None) == "critical"
                and getattr(alert, "kind", "breach") == "breach"):
            self.dump(reason=f"critical-alert:{alert.rule}")

    # --------------------------------------------------------------- dump
    def dump(self, reason: str = "manual", exc_info=None,
             signum: Optional[int] = None) -> pathlib.Path:
        """Write the bundle; returns its directory.  Never raises — a
        failing dump prints and returns (the process is already dying)."""
        d = self.bundle_dir
        try:
            d.mkdir(parents=True, exist_ok=True)
            tracer = self.tracer
            spans = (tracer.spans()[-self.span_capacity:]
                     if getattr(tracer, "enabled", False) else [])
            n_spans = write_spans_jsonl(spans, d / "spans.jsonl")
            (d / "metrics.json").write_text(
                json.dumps(_jsonable(self.registry.snapshot()), indent=2,
                           sort_keys=True) + "\n")
            with self._lock:
                deltas = list(self._deltas)
                alerts = list(self._alerts)
            with (d / "metric_deltas.jsonl").open("w") as f:
                for rec in deltas:
                    f.write(json.dumps(_jsonable(rec), sort_keys=True) + "\n")
            with (d / "alerts.jsonl").open("w") as f:
                for a in alerts:
                    rec = (a.to_dict() if hasattr(a, "to_dict")
                           else dataclasses.asdict(a))
                    f.write(json.dumps(_jsonable(rec), sort_keys=True) + "\n")
            files = ["manifest.json", "spans.jsonl", "metrics.json",
                     "metric_deltas.jsonl", "alerts.jsonl"]
            if self._policy is not None:
                (d / "policy.json").write_text(
                    json.dumps(_jsonable(dataclasses.asdict(self._policy)),
                               indent=2, sort_keys=True) + "\n")
                files.append("policy.json")
            if self._log_store is not None:
                try:
                    wal = self._log_store.tail_summary()
                except Exception as e:
                    wal = {"error": repr(e)}
                (d / "wal.json").write_text(
                    json.dumps(_jsonable(wal), indent=2, sort_keys=True)
                    + "\n")
                files.append("wal.json")
            manifest: Dict[str, Any] = {
                "reason": reason,
                "wall_time": time.time(),  # noqa: TID251 — postmortem
                "n_spans": n_spans,
                "n_deltas": len(deltas),
                "files": sorted(files),
            }
            if signum is not None:
                manifest["signal"] = int(signum)
            if exc_info is not None:
                manifest["exception"] = "".join(
                    traceback.format_exception(*exc_info)).strip()
            (d / "manifest.json").write_text(
                json.dumps(manifest, indent=2, sort_keys=True) + "\n")
            self.dumps += 1
            print(f"[flight] debug bundle ({reason}) -> {d}")
        except Exception as e:
            print(f"[flight] bundle dump failed: {e!r}", file=sys.stderr)
        return d

    # ------------------------------------------------------------ install
    def install(self, shutdown=None) -> "FlightRecorder":
        """Arm the crash triggers: chain ``sys.excepthook`` and (when a
        ``GracefulShutdown`` is given) register a signal-only dump — the
        callback checks ``shutdown.signum`` so clean ``close()`` exits
        never leave a bundle behind."""
        if self._prev_excepthook is None:
            prev = sys.excepthook

            def hook(tp, val, tb):
                self.dump(reason="unhandled-exception",
                          exc_info=(tp, val, tb))
                prev(tp, val, tb)

            self._prev_excepthook = prev
            sys.excepthook = hook
        if shutdown is not None:
            def on_signal():
                signum = getattr(shutdown, "signum", None)
                if signum is not None:
                    self.dump(reason="fatal-signal", signum=signum)

            shutdown.register("flight-recorder", on_signal)
        return self

    def uninstall(self) -> None:
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None


_active: Optional[FlightRecorder] = None


def get_flight_recorder() -> Optional[FlightRecorder]:
    return _active


def set_flight_recorder(recorder: Optional[FlightRecorder]) -> None:
    global _active
    _active = recorder
