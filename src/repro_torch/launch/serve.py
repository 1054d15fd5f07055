"""Production serving CLI: the CSV data plane + oracle model plane.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.1-8b --smoke

Builds the backbone on the card (random weights from a torch seed), the
embedding encoder, and answers semantic-filter requests through the CSV
filter with the batched engine.  On restart, the oracle call-cache
checkpoint avoids re-invoking the LLM.

``--service K`` switches to the concurrent front end
(repro_torch.service): K predicates become K ModelOracles over one
shared engine, submitted together so their per-round oracle batches
merge into cross-query dispatches, and the whole session (memo + caches
+ oracle call-caches) is checkpointed through a SessionStore instead of
the ad-hoc JSON cache — restart the same command and every predicate
replays at zero LLM calls.

The flags are the reference launcher's.  ``--smoke`` is a ``store_true``
flag whose default is already True, so the command line always serves
the smoke configuration of ``--arch``; a full-width run goes through
``serve_concurrent`` with an engine the caller builds.
"""
from __future__ import annotations

import argparse
import json
import pathlib

import torch

from repro_torch.api import ExecutionPolicy, Session
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import CSVConfig, SemanticTable
from repro_torch.core.oracle import ModelOracle
from repro_torch.data import HashTokenizer, make_dataset
from repro_torch.embeddings import EmbeddingModel
from repro_torch.models import lm
from repro_torch.obs import (FlightRecorder, HealthMonitor, LogAlertSink,
                             MetricsRegistry, StatusHub, Tracer,
                             default_rules, set_flight_recorder, set_monitor,
                             set_tracer, start_status_server,
                             write_run_profile)
from repro_torch.serving import ServingEngine
from repro_torch.utils.device import resolve_device

SERVICE_PREDICATES = [
    "the review is positive",
    "the review praises the acting",
    "the review discusses the plot",
    "the review would recommend the movie",
]


def start_metrics_server(registry: MetricsRegistry, port: int,
                         host: str = "127.0.0.1", hub: StatusHub = None,
                         label: str = "serve"):
    """Live observability endpoints on a daemon thread (stdlib only).

    /metrics serves the Prometheus dump (the historical scrape target);
    /healthz, /statusz, /varz come from ``repro_torch.obs.status``.  Binds
    loopback by default — pass ``host="0.0.0.0"`` explicitly to expose the
    listener.  Returns the server so callers/tests can ``shutdown()`` it.
    """
    return start_status_server(registry, port, host=host, hub=hub,
                               label=label)


def export_trace(trace_dir: str, tracer: Tracer, registry: MetricsRegistry,
                 *stats_objects):
    """Sync legacy stat objects into the registry and write all sinks."""
    registry.sync_from(*[s for s in stats_objects if s is not None])
    files = write_run_profile(pathlib.Path(trace_dir), tracer, registry)
    n_spans = len(tracer.spans())
    print(f"[serve] trace: {n_spans} spans -> {trace_dir} "
          f"(spans.jsonl, trace.json, ticks.jsonl, metrics.prom, "
          f"metrics.json)")
    return files


def sem_filter(table: SemanticTable, oracle, method: str = "csv",
               cfg: CSVConfig = None):
    """One predicate over ``table`` in a private ``Session`` on the
    table's device; returns the node's ``FilterResult``.

    The policy is the one the reference's ``SemanticTable.sem_filter``
    builds (memo and statistics reuse off, so each call is a cold run),
    and the node is named ``"pred"`` as there, so masks and calls equal
    the reference's."""
    if method not in ("csv", "csv-sim"):
        raise ValueError(f"unknown method {method!r}; expected 'csv' or "
                         "'csv-sim'")
    pol = ExecutionPolicy.from_csv_config(
        cfg or CSVConfig(), method=method, reuse_memo=False,
        reuse_stats=False)
    sess = Session(init_centroids=table.init_centroids, device=table.device)
    res = sess.table(table=table).filter(oracle, name="pred",
                                         policy=pol).collect()
    return res.raw.results["pred"]


def serve_concurrent(engine, tok, ds, embeddings, k: int, state_dir: str,
                     pipeline_depth: int = 1, shards: int = 1,
                     log_dir: str = None, hub: StatusHub = None,
                     flight: FlightRecorder = None):
    """K predicates through the concurrent service over one engine; the
    session's k-means and votes run on the engine's device."""
    from repro_torch.service import FilterService
    from repro_torch.service.lifecycle import GracefulShutdown

    preds = (SERVICE_PREDICATES * ((k - 1) // len(SERVICE_PREDICATES) + 1))[:k]
    sess = Session(policy=ExecutionPolicy(n_clusters=4, min_sample=25,
                                          pipeline_depth=pipeline_depth,
                                          shards=shards),
                   device=engine.device)
    table = sess.table(embeddings=embeddings, name="reviews")
    for i, text in enumerate(preds):
        sess.register_oracle(f"p{i}", ModelOracle(engine, tok, text,
                                                  ds.texts))
    if log_dir is not None:
        # append-only log (docs/distributed.md): continuous durability,
        # restart = snapshot + log-tail replay
        service = FilterService(sess, log_dir=log_dir)
        rep = service.restore()
        if rep is not None:
            print(f"[serve] restore: {rep}")
            if rep.n_dropped:
                print(f"[serve] WARNING: {rep.n_dropped} entry(ies) did "
                      "not survive the restart (see report above)")
    else:
        service = FilterService(sess, store_dir=state_dir)
        if service.store.exists():
            rep = service.restore()
            print(f"[serve] restore: {rep}")
            n_dropped = len(rep.dropped) + len(rep.skipped)
            if n_dropped:
                # a warm start that lost state must not look identical to
                # one that kept it all
                print(f"[serve] WARNING: {n_dropped} entry(ies) did not "
                      "survive the restart (see report above)")
    service.register_tenant("default", sess.policy)
    if hub is not None:
        # statusz sections come live as soon as the service exists
        hub.add_provider("tenants", service.status_view)
        hub.add_provider("scheduler", sess.scheduler.status_view)
        if service.log is not None:
            hub.add_provider("log", service.log.tail_summary)
    # exit-mode shutdown: SIGINT/SIGTERM writes a final session checkpoint
    # (best-effort mid-run — whatever rounds completed are memoized and
    # replay on restart) before exiting 128+signum; the normal path fires
    # the same once-only checkpoint via shutdown.close() below, which also
    # puts the previous signal handlers back
    shutdown = GracefulShutdown(exit_on_signal=True).install()
    shutdown.register("service-checkpoint", service.checkpoint)
    if flight is not None:
        flight.attach_policy(sess.policy)
        if service.log is not None:
            flight.attach_log(service.log)
        flight.install(shutdown=shutdown)  # signal-only dump + excepthook
    try:
        with sess.scheduler.holding():
            tickets = [service.submit("default", table.filter(f"p{i}"),
                                      label=f"p{i}") for i in range(k)]
        results = service.gather(*tickets)
    except BaseException:
        shutdown.close()   # checkpoint what completed, restore handlers
        service.close()
        raise
    for i, (text, r) in enumerate(zip(preds, results)):
        print(f"[serve] p{i} {text!r}: {int(r.mask.sum())}/{len(table)} "
              f"pass; {r.n_llm_calls} LLM calls, {r.n_replayed} replayed")
    merge = sess.scheduler.stats.merge
    print(f"[serve] merged dispatches: {merge.n_invocations}, mean "
          f"{merge.mean_batch_size:.0f} ids/invocation "
          f"(merge factor {merge.merge_factor:.1f}); engine={engine.stats}")
    print(f"[serve] per-tick: {merge.mean_wall_s * 1e3:.1f} ms mean "
          f"({merge.last_wall_s * 1e3:.1f} ms last), "
          f"{merge.tokens_per_s:.0f} oracle tokens/s; "
          f"engine mean batch {engine.mean_batch_size:.1f}, "
          f"bucket fill {engine.batcher.fill_ratio:.2f}, "
          f"truncated prompts {merge.n_truncated}")
    shutdown.close()   # final checkpoint (once) + restore signal handlers
    print(f"[serve] session checkpointed to {log_dir or state_dir} — rerun "
          "to replay at 0 LLM calls")
    service.close()
    return sess, results


def main(argv=None, device="cuda"):
    """The CLI.  ``device`` is for in-process callers (tests pass
    ``"cpu"``); it is not a command-line flag.  Returns ``(engine,
    session, results)`` under ``--service``, else ``(engine, oracle,
    result)``."""
    dev = resolve_device(device)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.1-8b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--n", type=int, default=400)
    ap.add_argument("--predicate", default="the review is positive")
    ap.add_argument("--vote", default="csv", choices=["csv", "csv-sim"])
    ap.add_argument("--cache", default="/tmp/repro_serve_cache.json")
    ap.add_argument("--service", type=int, default=0, metavar="K",
                    help="serve K concurrent predicates through "
                         "repro_torch.service (cross-query batching + "
                         "restartable session store)")
    ap.add_argument("--state-dir", default="/tmp/repro_serve_state",
                    help="SessionStore directory for --service mode")
    ap.add_argument("--log-dir", default=None, metavar="DIR",
                    help="append-only session log directory (--service "
                         "mode); replaces --state-dir snapshots with "
                         "continuous checkpointing + log-tail restarts")
    ap.add_argument("--shards", type=int, default=1,
                    help="split each CSV round's sample/oracle/vote wave "
                         "across N shards (bit-identical to 1)")
    ap.add_argument("--attn-impl", default=None,
                    choices=["auto", "plain", "chunked", "tri", "flash",
                             "flash-ref"],
                    help="override the model's attention path; 'flash' "
                         "runs the CUDA prefill kernel")
    ap.add_argument("--pipeline-depth", type=int, default=1,
                    help="service tick waves: prefill of wave k+1 "
                         "overlaps voting on wave k (--service mode)")
    ap.add_argument("--max-batch", type=int, default=64,
                    help="engine device batch cap per bucket")
    ap.add_argument("--trace-dir", default=None, metavar="DIR",
                    help="enable tracing; write spans.jsonl, Perfetto "
                         "trace.json, ticks.jsonl, metrics.prom and "
                         "metrics.json under DIR on exit")
    ap.add_argument("--metrics-port", type=int, default=0, metavar="PORT",
                    help="serve live /metrics, /healthz, /statusz and "
                         "/varz on PORT (0 = off)")
    ap.add_argument("--metrics-host", default="127.0.0.1", metavar="HOST",
                    help="bind address for --metrics-port (default "
                         "loopback; pass 0.0.0.0 to expose)")
    ap.add_argument("--flight-dir", default=None, metavar="DIR",
                    help="arm the flight recorder: dump a debug bundle "
                         "under DIR on unhandled exception, fatal signal, "
                         "or critical health alert")
    ap.add_argument("--linger", type=float, default=0.0, metavar="SECONDS",
                    help="keep the process (and status endpoints) alive "
                         "SECONDS after the run completes")
    ap.add_argument("--inject-failure", action="store_true",
                    help="raise after the run completes (CI: exercises "
                         "the flight recorder's crash path)")
    args = ap.parse_args(argv)

    registry = MetricsRegistry()
    tracer = None
    monitor = None
    flight = None
    hub = None
    if args.trace_dir or args.metrics_port or args.flight_dir:
        # live metrics need the tracer installed even when only --metrics-port
        # is given: instrumented code publishes through get_tracer().metrics
        tracer = Tracer(metrics=registry)
        set_tracer(tracer)
        monitor = HealthMonitor(registry, rules=default_rules(),
                                sinks=[LogAlertSink("[serve][health]")])
        set_monitor(monitor)
    if args.flight_dir:
        flight = FlightRecorder(args.flight_dir, tracer=tracer,
                                registry=registry)
        flight.install()           # excepthook now; signal hook in-service
        set_flight_recorder(flight)
        monitor.add_sink(flight.note_alert)  # critical alerts dump too
    if args.metrics_port:
        hub = StatusHub(monitor=monitor, flight=flight)
        start_metrics_server(registry, args.metrics_port,
                             host=args.metrics_host, hub=hub)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.attn_impl:
        cfg = cfg.replace(attn_impl=args.attn_impl)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    engine = ServingEngine(cfg, params, max_batch=args.max_batch, device=dev)
    tok = HashTokenizer(cfg.vocab_size)

    ds = make_dataset("imdb_review", n=args.n, seed=0)
    encoder = EmbeddingModel(smoke_config("e5-large"), max_len=32, device=dev)
    embeddings = encoder.encode(ds.texts)

    if args.service > 0:
        sess, results = serve_concurrent(
            engine, tok, ds, embeddings, args.service,
            args.state_dir, pipeline_depth=args.pipeline_depth,
            shards=args.shards, log_dir=args.log_dir, hub=hub,
            flight=flight)
        if tracer is not None and args.trace_dir:
            print(results[0].profile())
            export_trace(args.trace_dir, tracer, registry,
                         sess.scheduler.stats, engine.batcher)
        _epilogue(args, flight)
        return engine, sess, results

    oracle = ModelOracle(engine, tok, args.predicate, ds.texts)
    cache_path = pathlib.Path(args.cache)
    if cache_path.exists():
        oracle.memo_restore(json.loads(cache_path.read_text()))
        print(f"[serve] restored {len(oracle.memo_snapshot())} cached calls")

    table = SemanticTable(texts=ds.texts, embeddings=embeddings, device=dev)
    r = sem_filter(table, oracle, method=args.vote,
                   cfg=CSVConfig(n_clusters=4, min_sample=25))
    cache_path.write_text(json.dumps(
        {str(k): v for k, v in oracle.memo_snapshot().items()}))
    print(f"[serve] predicate={args.predicate!r}: {int(r.mask.sum())}/{args.n} "
          f"pass; {r.n_llm_calls} LLM calls "
          f"({args.n/max(1, r.n_llm_calls):.1f}x reduction); "
          f"engine={engine.stats}")
    if tracer is not None and args.trace_dir:
        export_trace(args.trace_dir, tracer, registry,
                     getattr(oracle, "stats", None), engine.batcher)
    _epilogue(args, flight)
    return engine, oracle, r


def _epilogue(args, flight):
    """Post-run hold/failure hooks shared by both serve modes."""
    if args.linger > 0:
        import time
        from repro_torch.obs import get_monitor
        from repro_torch.utils.timing import monotonic
        print(f"[serve] lingering {args.linger:g}s for live scrapes")
        end = monotonic() + args.linger
        try:
            while monotonic() < end:
                time.sleep(0.5)
                get_monitor().maybe_evaluate()
                if flight is not None:
                    flight.record_delta()
        except KeyboardInterrupt:
            pass
    if args.inject_failure:
        # deliberately crash AFTER the workload so the flight recorder's
        # excepthook path is exercised with a real span/metric history
        raise RuntimeError("injected failure (--inject-failure)")


if __name__ == "__main__":
    main()
