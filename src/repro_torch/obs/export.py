"""Export sinks: JSONL span log, Chrome/Perfetto trace, Prometheus text.

All sinks are pure functions over a span list / registry snapshot — no
background threads, no buffering — so a run can export the same tracer to
several formats.  ``write_run_profile`` is the one-call bundle the serve
driver's ``--trace-dir`` flag uses:

    trace_dir/
      spans.jsonl     one span per line (span_id/parent_id/name/attrs)
      trace.json      Chrome trace-event JSON — load in ui.perfetto.dev
      metrics.prom    Prometheus text exposition of the registry
      metrics.json    registry snapshot (counters/gauges/histograms)
      ticks.jsonl     one line per dispatch_wave span (per-tick snapshot)
"""
from __future__ import annotations

import json
import pathlib
from typing import Iterable, List

import numpy as np


def _jsonable(v):
    """Attrs may carry numpy scalars/arrays; make them JSON-clean."""
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return repr(v)


# ------------------------------------------------------------------- JSONL
def write_spans_jsonl(spans: Iterable, path) -> int:
    """One span per line; returns the number of spans written."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    n = 0
    with path.open("w") as f:
        for sp in spans:
            f.write(json.dumps(_jsonable(sp.to_dict()), sort_keys=True))
            f.write("\n")
            n += 1
    return n


# ---------------------------------------------------------------- Perfetto
def spans_to_perfetto(spans: List, epoch_mono: float = 0.0,
                      pid: int = 1) -> dict:
    """Chrome trace-event JSON (``ph: "X"`` complete events).

    Timestamps are microseconds relative to the tracer epoch; each OS
    thread becomes a Perfetto track (named via metadata events), so nesting
    inside a thread is rendered by containment and cross-thread edges stay
    inspectable through the ``parent_id`` arg on every slice.
    """
    events = []
    tids: dict = {}
    for sp in spans:
        tid = tids.setdefault(sp.thread, len(tids) + 1)
        t1 = sp.t1 if sp.t1 is not None else sp.t0
        events.append({
            "name": sp.name, "cat": sp.kind, "ph": "X", "pid": pid,
            "tid": tid,
            "ts": (sp.t0 - epoch_mono) * 1e6,
            "dur": max(0.0, (t1 - sp.t0) * 1e6),
            "args": _jsonable({"span_id": sp.span_id,
                               "parent_id": sp.parent_id, **sp.attrs}),
        })
    for thread, tid in tids.items():
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": thread}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_perfetto(spans: List, path, epoch_mono: float = 0.0) -> int:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    doc = spans_to_perfetto(spans, epoch_mono=epoch_mono)
    path.write_text(json.dumps(doc) + "\n")
    return len(doc["traceEvents"])


# -------------------------------------------------------------- Prometheus
def _prom_name(name: str) -> str:
    return "".join(c if (c.isalnum() or c == "_") else "_" for c in name)


def registry_to_prometheus(registry) -> str:
    """Prometheus text exposition format (HELP/TYPE comments + samples)."""
    lines: List[str] = []
    for name, m in registry._iter_instruments():
        pname = _prom_name(name)
        lines.append(f"# HELP {pname} repro metric {name}")
        if m.kind == "histogram":
            lines.append(f"# TYPE {pname} histogram")
            cum = 0
            for bound, c in zip([*m.bounds, float("inf")], m.counts):
                cum += c
                le = "+Inf" if bound == float("inf") else format(bound, "g")
                lines.append(f'{pname}_bucket{{le="{le}"}} {cum}')
            lines.append(f"{pname}_sum {m.sum}")
            lines.append(f"{pname}_count {m.count}")
        else:
            try:
                value = float(m.value)
            except (TypeError, ValueError):
                # non-numeric gauge (someone .set() a string): expose it
                # through the info idiom rather than crashing the scrape
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f'{pname}{{value="{m.value}"}} 1')
                continue
            lines.append(f"# TYPE {pname} {m.kind}")
            lines.append(f"{pname} {value}")
    for name, v in registry._iter_info():
        pname = _prom_name(name)
        lines.append(f"# HELP {pname} repro info {name}")
        lines.append(f"# TYPE {pname} gauge")
        lines.append(f'{pname}{{value="{v}"}} 1')
    return "\n".join(lines) + ("\n" if lines else "")


def write_prometheus(registry, path) -> str:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    text = registry_to_prometheus(registry)
    path.write_text(text)
    return text


# ------------------------------------------------------------- run bundles
def write_ticks_jsonl(spans: List, path) -> int:
    """Per-tick snapshots: one JSON line per ``dispatch_wave`` span."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    n = 0
    with path.open("w") as f:
        for sp in spans:
            if sp.kind != "dispatch_wave":
                continue
            rec = {"span_id": sp.span_id, "wall_s": sp.duration_s,
                   **sp.attrs}
            f.write(json.dumps(_jsonable(rec), sort_keys=True))
            f.write("\n")
            n += 1
    return n


def write_run_profile(trace_dir, tracer, registry=None) -> dict:
    """Write the full artifact set for one run; returns written counts."""
    trace_dir = pathlib.Path(trace_dir)
    trace_dir.mkdir(parents=True, exist_ok=True)
    spans = tracer.spans()
    registry = registry if registry is not None else tracer.metrics
    out = {
        "spans": write_spans_jsonl(spans, trace_dir / "spans.jsonl"),
        "trace_events": write_perfetto(spans, trace_dir / "trace.json",
                                       epoch_mono=tracer.epoch_mono),
        "ticks": write_ticks_jsonl(spans, trace_dir / "ticks.jsonl"),
    }
    write_prometheus(registry, trace_dir / "metrics.prom")
    (trace_dir / "metrics.json").write_text(
        json.dumps(_jsonable(registry.snapshot()), indent=2, sort_keys=True)
        + "\n")
    return out
