"""Unified observability: tracing, metrics, audit, health, status, export.

See docs/observability.md for the span taxonomy, metric naming scheme,
online quality auditing, health rules, and the flight recorder.
"""
from repro_torch.obs.audit import (
    AuditReport,
    audit_labels,
    audit_query_result,
    stratified_sample,
    wilson_interval,
)
from repro_torch.obs.export import (
    registry_to_prometheus,
    spans_to_perfetto,
    write_perfetto,
    write_prometheus,
    write_run_profile,
    write_spans_jsonl,
    write_ticks_jsonl,
)
from repro_torch.obs.flight import (
    FlightRecorder,
    get_flight_recorder,
    set_flight_recorder,
)
from repro_torch.obs.health import (
    Alert,
    CallbackAlertSink,
    HealthMonitor,
    HealthRule,
    JsonlAlertSink,
    LogAlertSink,
    NULL_MONITOR,
    default_rules,
    get_monitor,
    set_monitor,
)
from repro_torch.obs.metrics import (
    DEFAULT_BOUNDS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NULL_REGISTRY,
    NullRegistry,
)
from repro_torch.obs.status import (
    StatusHub,
    start_status_server,
)
from repro_torch.obs.trace import (
    NULL_SPAN,
    NULL_TRACER,
    NullTracer,
    Span,
    Tracer,
    get_tracer,
    set_tracer,
    use_tracer,
)

__all__ = [
    "Alert",
    "AuditReport",
    "CallbackAlertSink",
    "Counter",
    "DEFAULT_BOUNDS",
    "FlightRecorder",
    "Gauge",
    "HealthMonitor",
    "HealthRule",
    "Histogram",
    "JsonlAlertSink",
    "LogAlertSink",
    "MetricsRegistry",
    "NULL_MONITOR",
    "NULL_REGISTRY",
    "NULL_SPAN",
    "NULL_TRACER",
    "NullRegistry",
    "NullTracer",
    "Span",
    "StatusHub",
    "Tracer",
    "audit_labels",
    "audit_query_result",
    "default_rules",
    "get_flight_recorder",
    "get_monitor",
    "get_tracer",
    "registry_to_prometheus",
    "set_flight_recorder",
    "set_monitor",
    "set_tracer",
    "spans_to_perfetto",
    "start_status_server",
    "stratified_sample",
    "use_tracer",
    "wilson_interval",
    "write_perfetto",
    "write_prometheus",
    "write_run_profile",
    "write_spans_jsonl",
    "write_ticks_jsonl",
]
