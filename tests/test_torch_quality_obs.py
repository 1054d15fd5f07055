"""The port's health, status, flight-recorder and export layers against the
JAX reference, and the two observability repairs.

The health, status, flight and exporter cases of
tests/test_quality_obs.py and the export cases of tests/test_obs.py on
``repro_torch.obs``, each also held against ``repro.obs`` on the same
inputs (alert sequences, status documents, the Prometheus text of equal
registries, span trees and metric names of a traced service run).  The
repairs: the audit reports 0 tokens for an oracle whose ``_tokens_of``
raises anything, as the reference does; a sharded round (``shards=4``)
opens the reference's spans (``gather`` included) and fills the
reference's metric registry, names and counts alike.
"""
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import api as japi
from repro import obs as jobs
from repro.core import clustering as jc
from repro.core.csv_filter import CSVConfig as JCSVConfig
from repro.core.csv_filter import semantic_filter as j_semantic_filter
from repro.core.oracle import SyntheticOracle as JSyntheticOracle
from repro.data import make_dataset
from repro_torch import api as tapi
from repro_torch import obs as tobs
from repro_torch.core.csv_filter import CSVConfig, semantic_filter
from repro_torch.core.oracle import SyntheticOracle
from repro_torch.obs import (FlightRecorder, HealthMonitor, MetricsRegistry,
                             StatusHub, Tracer, default_rules,
                             registry_to_prometheus, set_flight_recorder,
                             set_monitor, spans_to_perfetto,
                             start_status_server, use_tracer,
                             write_run_profile)
from repro_torch.obs.trace import PORT_ONLY_KINDS

N = 600
_plusplus = jax.jit(jc._plusplus_init, static_argnums=2)


def jax_seeder(seed, x, k):
    return np.asarray(_plusplus(jax.random.key(seed), jnp.asarray(x), k))


OBS = {"ref": jobs, "port": tobs}
SIDES = {"ref": (japi, JSyntheticOracle), "port": (tapi, SyntheticOracle)}


@pytest.fixture(scope="module")
def ds():
    return make_dataset("imdb_review", n=N, seed=0)


def _session(side):
    pol = SIDES[side][0].ExecutionPolicy(n_clusters=4, xi=0.005)
    if side == "ref":
        return japi.Session(policy=pol)
    return tapi.Session(policy=pol, init_centroids=jax_seeder, device="cpu")


def _oracle(side, ds, q="RV-Q1", seed=7):
    return SIDES[side][1](ds.labels[q], flip_prob=0.02, seed=seed,
                          token_lens=ds.token_lens)


def _run_concurrent(side, ds):
    """3 concurrent queries (2 leaves + 1 cascade) through the scheduler."""
    sess = _session(side)
    t = sess.table(embeddings=ds.embeddings, name="reviews")
    qs = [t.filter(_oracle(side, ds, "RV-Q1"), name="A"),
          t.filter(_oracle(side, ds, "RV-Q3"), name="B"),
          t.filter(_oracle(side, ds, "RV-Q1", seed=11), name="C")
          & t.filter(_oracle(side, ds, "RV-Q3", seed=12), name="D")]
    try:
        with sess.scheduler.holding():
            tickets = [sess.submit(q) for q in qs]
        return sess.gather(*tickets)
    finally:
        sess.close()


@pytest.fixture(scope="module")
def traced(ds):
    out = {}
    for side in ("ref", "port"):
        tr = OBS[side].Tracer(metrics=OBS[side].MetricsRegistry())
        with OBS[side].use_tracer(tr):
            results = _run_concurrent(side, ds)
        out[side] = (tr, results)
    return out


def _chain(s, by_id):
    kinds = []
    while s is not None:
        kinds.append(s.kind)
        s = by_id.get(s.parent_id)
    return tuple(reversed(kinds))


def _shared(spans):
    """The spans the reference opens too: all but the port's own leaves
    (``PORT_ONLY_KINDS``)."""
    return [s for s in spans if s.kind not in PORT_ONLY_KINDS]


def _tree_kinds(spans):
    """Every span as the kinds from its root down, sorted (threads make
    the creation order differ between runs)."""
    by_id = {s.span_id: s for s in spans}
    return sorted(_chain(s, by_id) for s in spans)


def _metric_counts(snap):
    """A registry snapshot without times: counters and gauges as they
    are, histograms by count (and sum, for the vote margins)."""
    out = {}
    for name, v in snap.items():
        if isinstance(v, dict):
            out[name] = (v["count"], round(v["sum"], 9)
                         if name.startswith("quality.") else None)
        elif not (name.endswith("_s") or name.endswith("wall_s")
                  or "per_s" in name):
            out[name] = v
    return out


# ------------------------------------------------- export cases (test_obs)
def test_span_ids_unique_and_parents_resolve(traced):
    tr, _ = traced["port"]
    spans = tr.spans()
    ids = [s.span_id for s in spans]
    assert len(ids) == len(set(ids))
    by_id = {s.span_id: s for s in spans}
    for s in spans:
        assert s.parent_id is None or s.parent_id in by_id
        assert s.t1 is not None and s.t1 >= s.t0


def test_spans_nest_query_to_dispatch_wave(traced):
    tr, _ = traced["port"]
    spans = tr.spans()
    by_id = {s.span_id: s for s in spans}
    kinds = {s.kind for s in spans}
    assert {"query", "plan_node", "round", "plan", "oracle", "vote",
            "dispatch_wave"} <= kinds
    roots = [s for s in spans if s.kind == "query"]
    assert len(roots) == 3 and all(s.parent_id is None for s in roots)
    waves = [s for s in spans if s.kind == "dispatch_wave"]
    assert waves
    for w in waves:
        assert _chain(w, by_id) == ("query", "plan_node", "round", "oracle",
                                    "dispatch_wave")
    assert all("n_sampled" in r.attrs for r in spans if r.kind == "round")
    # the same span tree as the reference's traced run
    assert _tree_kinds(_shared(spans)) == _tree_kinds(
        traced["ref"][0].spans())


def test_parity_filter_leaves_out_only_the_ports_own_leaves(traced):
    """What the parity tests leave out: only spans of the port's own
    kinds, each a leaf, so every span the reference opens is compared."""
    spans = traced["port"][0].spans()
    kept = _shared(spans)
    dropped = [s for s in spans if s.kind in PORT_ONLY_KINDS]
    assert PORT_ONLY_KINDS == ("step", "layer")
    assert dropped and len(kept) + len(dropped) == len(spans)
    assert {s.kind for s in kept} == {s.kind for s in spans} - {"step"}
    gone = {s.span_id for s in dropped}
    assert not any(s.parent_id in gone for s in spans)
    assert len(kept) == len(traced["ref"][0].spans())


def test_metrics_registry_unified_names(traced):
    tr, results = traced["port"]
    snap = tr.metrics.snapshot()
    assert snap["oracle.calls"] == sum(r.n_llm_calls for r in results)
    assert snap["query.collects"] == 3
    assert snap["driver.rounds"] >= 1
    assert snap["round.wall_s"]["count"] == snap["driver.rounds"]
    assert snap["service.ticks"] >= 1
    prom = registry_to_prometheus(tr.metrics)
    assert "oracle_calls" in prom and "service_wave_wall_s_bucket" in prom
    assert prom == tr.metrics.to_prometheus()
    assert _metric_counts(snap) == _metric_counts(
        traced["ref"][0].metrics.snapshot())


def test_perfetto_export_valid_json(traced, tmp_path):
    tr, _ = traced["port"]
    doc = json.loads(json.dumps(spans_to_perfetto(tr.spans(), tr.epoch_mono)))
    slices = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(slices) == len(tr.spans())
    for e in slices:
        assert e["ts"] >= 0 and e["dur"] >= 0
        assert {"pid", "tid", "name", "cat"} <= e.keys()
    named = {e["tid"] for e in doc["traceEvents"] if e["ph"] == "M"}
    assert {e["tid"] for e in slices} <= named
    files = write_run_profile(tmp_path, tr, tr.metrics)
    for f in ("spans.jsonl", "trace.json", "ticks.jsonl", "metrics.prom",
              "metrics.json"):
        assert (tmp_path / f).stat().st_size > 0
    assert int(files["ticks"]) >= 1
    # the Tracer's own export methods write the same documents
    assert tr.export_jsonl(tmp_path / "t.jsonl") == len(tr.spans())
    tr.export_perfetto(tmp_path / "t.json")
    again = json.loads((tmp_path / "t.json").read_text())
    assert len([e for e in again["traceEvents"] if e["ph"] == "X"]) == \
        len(slices)


def test_disabled_tracer_bit_identical(ds, traced):
    _, with_trace = traced["port"]
    assert not tobs.get_tracer().enabled
    plain = _run_concurrent("port", ds)
    for a, b in zip(plain, with_trace):
        np.testing.assert_array_equal(a.mask, b.mask)
        assert a.n_llm_calls == b.n_llm_calls
        assert a.n_replayed == b.n_replayed
    for a, b in zip(with_trace, traced["ref"][1]):
        np.testing.assert_array_equal(a.mask, b.mask)
        assert a.n_llm_calls == b.n_llm_calls


# ------------------------------------------------------- health monitor
def _trip_sequence(side):
    reg = OBS[side].MetricsRegistry()
    reg.counter("oracle.calls").inc(100)
    alerts = []
    mon = OBS[side].HealthMonitor(
        reg, rules=[OBS[side].HealthRule(
            name="too-many-calls", metric="oracle.calls", threshold=150.0,
            op=">", severity="warning", message="call budget runs hot")],
        sinks=[], min_interval_s=0.0)
    mon.add_sink(alerts.append)
    mon.evaluate()
    assert alerts == [] and mon.status()["status"] == "ok"
    reg.counter("oracle.calls").inc(100)
    for _ in range(3):
        mon.evaluate()                   # still breached: silent
    breaches = [a for a in alerts if a.kind == "breach"]
    assert len(breaches) == 1 and breaches[0].rule == "too-many-calls"
    assert mon.status()["status"] == "degraded"
    assert "too-many-calls" in mon.firing()
    reg.counter("oracle.calls").value = 10.0
    mon.evaluate()
    assert [a.kind for a in alerts] == ["breach", "recover"]
    assert mon.status()["status"] == "ok"
    reg.counter("oracle.calls").inc(500)
    mon.evaluate()
    return [(a.kind, a.rule, a.severity, a.value) for a in alerts]


def test_alert_trips_once_per_breach_and_recovers():
    got = _trip_sequence("port")
    assert [k for k, *_ in got] == ["breach", "recover", "breach"]
    assert got == _trip_sequence("ref")


def test_default_rules_quiet_on_empty_registry():
    mon = HealthMonitor(MetricsRegistry(), rules=default_rules(),
                        sinks=[], min_interval_s=0.0)
    mon.evaluate()
    assert not any(mon.firing().values())
    assert mon.status()["status"] == "ok"
    assert [r.name for r in default_rules()] == \
        [r.name for r in jobs.default_rules()]


def test_jsonl_alert_sink_and_critical_hook(tmp_path):
    docs = {}
    for side in ("ref", "port"):
        reg = OBS[side].MetricsRegistry()
        reg.set("service.tenant_budget_used_ratio", 0.95)
        crit = []
        path = tmp_path / f"{side}.jsonl"
        mon = OBS[side].HealthMonitor(
            reg, rules=OBS[side].default_rules(),
            sinks=[OBS[side].JsonlAlertSink(path)], min_interval_s=0.0,
            on_critical=crit.append)
        mon.evaluate()
        lines = path.read_text().splitlines()
        assert len(lines) == 1 and len(crit) == 1
        assert mon.status()["status"] == "critical"
        docs[side] = {k: v for k, v in json.loads(lines[0]).items()
                      if k != "wall_time"}
    assert docs["port"]["rule"] == "tenant-budget-burn"
    assert docs["port"]["severity"] == "critical"
    assert docs["port"]["kind"] == "breach"
    assert docs["port"] == docs["ref"]


# ------------------------------------------------------ status endpoints
def test_status_endpoints_live():
    reg = MetricsRegistry()
    reg.counter("oracle.calls").inc(42)
    mon = HealthMonitor(reg, rules=default_rules(), sinks=[],
                        min_interval_s=0.0)
    hub = StatusHub(monitor=mon)
    hub.add_provider("tenants", lambda: {"alice": {"budget": 100}})
    srv = start_status_server(reg, 0, hub=hub, label="test")
    host, port = srv.server_address[:2]
    assert host == "127.0.0.1"
    base = f"http://{host}:{port}"
    try:
        def get(path):
            with urllib.request.urlopen(base + path, timeout=5) as r:
                return (r.status, r.headers.get("Content-Type", ""),
                        r.read().decode())

        code, ctype, body = get("/healthz")
        assert code == 200 and "json" in ctype
        doc = json.loads(body)
        assert doc["status"] == "ok" and doc["uptime_s"] >= 0
        doc = json.loads(get("/statusz")[2])
        assert doc["tenants"] == {"alice": {"budget": 100}}
        assert "health" in doc
        _, ctype, body = get("/statusz?format=html")
        assert "html" in ctype and "<html" in body
        assert json.loads(get("/varz")[2])["oracle.calls"] == 42.0
        body = get("/metrics")[2]
        assert "oracle_calls 42" in body
        assert body == registry_to_prometheus(reg)
        hub.add_provider("boom", lambda: 1 / 0)
        assert "error" in json.loads(get("/statusz")[2])["boom"]
    finally:
        srv.shutdown()
        srv.server_close()


# ------------------------------------------------------- flight recorder
def test_flight_recorder_dump_parseable(ds, tmp_path):
    reg = MetricsRegistry()
    tr = Tracer(metrics=reg)
    with use_tracer(tr):
        sess = _session("port")
        sess.table(embeddings=ds.embeddings, name="reviews").filter(
            _oracle("port", ds), name="q").collect()
    fr = FlightRecorder(tmp_path / "debug-bundle", tracer=tr, registry=reg)
    fr.record_delta()
    reg.counter("oracle.calls").inc(7)
    fr.record_delta()
    d = fr.dump("test-dump")
    man = json.loads((d / "manifest.json").read_text())
    assert man["reason"] == "test-dump" and man["n_spans"] > 0
    assert "oracle.calls" in json.loads((d / "metrics.json").read_text())
    spans = [json.loads(ln)
             for ln in (d / "spans.jsonl").read_text().splitlines()]
    assert spans and all("span_id" in s for s in spans)
    deltas = [json.loads(ln) for ln in
              (d / "metric_deltas.jsonl").read_text().splitlines()]
    assert any(dl["delta"].get("oracle.calls") == 7.0 for dl in deltas)


def test_flight_recorder_dumps_on_critical_alert(tmp_path):
    reg = MetricsRegistry()
    fr = FlightRecorder(tmp_path / "debug-bundle", tracer=None, registry=reg)
    set_flight_recorder(fr)
    try:
        reg.set("service.tenant_budget_used_ratio", 0.99)
        mon = HealthMonitor(reg, rules=default_rules(),
                            sinks=[fr.note_alert], min_interval_s=0.0)
        mon.evaluate()
        man = json.loads(
            (tmp_path / "debug-bundle" / "manifest.json").read_text())
        assert man["reason"] == "critical-alert:tenant-budget-burn"
        assert fr.dumps == 1
    finally:
        set_flight_recorder(None)
        set_monitor(None)


# ----------------------------------------------------- exporter hardening
def _exporter_registry(side):
    reg = OBS[side].MetricsRegistry()
    reg.counter("oracle.calls").inc(3)
    reg.histogram("round.wall_s").observe(0.5)
    reg.set_info("run.arch", "qwen1.5-0.5b")
    reg.gauge("weird.gauge").set("not-a-number")
    return reg


def test_prometheus_export_help_le_and_info():
    text = registry_to_prometheus(_exporter_registry("port"))
    assert "# HELP oracle_calls" in text
    assert "# HELP round_wall_s" in text
    assert 'le="0.5"' in text and 'le="+Inf"' in text
    assert 'le="0.001"' in text and 'le="0.001000' not in text
    assert 'weird_gauge{value="not-a-number"} 1' in text
    assert 'run_arch{value="qwen1.5-0.5b"} 1' in text
    # equal registries give the reference's text byte for byte
    assert text == jobs.registry_to_prometheus(_exporter_registry("ref"))
    assert tobs.NULL_REGISTRY.to_prometheus() == ""


# ------------------------------------------------------------- repairs
class _DuckOracle:
    """A duck-typed oracle: labels, no memo, token counting that fails."""

    def __init__(self, labels):
        self.labels = labels

    def _evaluate(self, ids):
        return self.labels[ids]

    def _tokens_of(self, ids):
        raise ValueError("this oracle cannot count tokens")


@pytest.mark.parametrize("side", ["ref", "port"])
def test_audit_reports_zero_tokens_when_token_counting_raises(side):
    labels = np.arange(10) % 3 == 0
    out, n_fresh, hits, tokens = OBS[side].audit_labels(
        _DuckOracle(labels), np.arange(2, 8))
    np.testing.assert_array_equal(out, labels[2:8])
    assert (n_fresh, hits, tokens) == (6, 0, 0)


def _traced_filter(side, ds, shards):
    reg = OBS[side].MetricsRegistry()
    tr = OBS[side].Tracer(metrics=reg)
    Oracle = SIDES[side][1]
    oracle = Oracle(ds.labels["RV-Q1"], flip_prob=0.02, seed=7,
                    token_lens=ds.token_lens)
    with OBS[side].use_tracer(tr):
        if side == "ref":
            res = j_semantic_filter(ds.embeddings, oracle, JCSVConfig(
                n_clusters=4, xi=0.005, vote="sim", shards=shards))
        else:
            res = semantic_filter(ds.embeddings, oracle, CSVConfig(
                n_clusters=4, xi=0.005, vote="sim", shards=shards),
                init_centroids=jax_seeder, device="cpu")
    spans = [(s.kind, s.name, sorted(s.attrs)) for s in _shared(tr.spans())]
    gathers = [dict(s.attrs) for s in tr.spans() if s.kind == "gather"]
    return res, spans, gathers, _metric_counts(reg.snapshot())


@pytest.mark.parametrize("shards", [1, 4])
def test_sharded_round_observability_matches_reference(shards):
    """Span kinds, names and attribute names in order, the gather spans'
    attributes, and the registry's metric names and counts equal the
    reference's; ``quality.vote_margin`` only where the reference
    observes it (unsharded rounds)."""
    ds = make_dataset("imdb_review", n=3000, seed=0)
    res, spans, gathers, metrics = _traced_filter("port", ds, shards)
    jres, jspans, jgathers, jmetrics = _traced_filter("ref", ds, shards)
    np.testing.assert_array_equal(res.mask, jres.mask)
    assert res.n_llm_calls == jres.n_llm_calls
    assert spans == jspans
    assert gathers == jgathers
    assert metrics == jmetrics
    if shards > 1:
        assert gathers and all(g["shards"] >= 1 for g in gathers)
        assert metrics["distributed.sharded_rounds"] == len(gathers)
        assert "quality.vote_margin" not in metrics
    else:
        assert not gathers and "distributed.sharded_rounds" not in metrics
        assert metrics["quality.vote_margin"][0] > 0
