"""Stream watcher CLI: standing semantic queries over a replayed feed.

    PYTHONPATH=src python -m repro_torch.launch.watch --n 400 --queries 3

Replays a deterministic stream against K standing queries over one
session (docs/streaming.md): rows arrive per tick under a per-source
rate budget, each tick coalesced-appends them and re-votes only the
touched clusters, and every newly-matching row is pushed exactly once to
a JSONL sink.  The watcher checkpoints through a ``SessionStore`` —
rerun the same command after a kill (``--kill-after`` simulates one) and
it restores mid-stream: no already-notified row re-notifies, and the
rebuild itself costs ~0 oracle calls.

Default oracles are synthetic (seeded labels — fast, deterministic).
``--engine`` builds the smoke backbone on the card instead (random
weights from a torch seed) and answers every standing predicate with
``ModelOracle`` prompts batched across queries through the scheduler,
exactly like ``serve --service``.  The session's k-means patches and
votes run on the card either way.
"""
from __future__ import annotations

import argparse
import pathlib

import numpy as np

from repro_torch.api import ExecutionPolicy, Session
from repro_torch.core import SyntheticOracle
from repro_torch.data import make_dataset
from repro_torch.obs import (FlightRecorder, HealthMonitor, LogAlertSink,
                             MetricsRegistry, StatusHub, Tracer,
                             default_rules, set_flight_recorder, set_monitor,
                             set_tracer)
from repro_torch.service.lifecycle import GracefulShutdown
from repro_torch.service.store import SessionStore
from repro_torch.stream import (JsonlSink, RateBudget, StreamWatcher,
                                SyntheticSource)
from repro_torch.utils.device import resolve_device

WATCH_PREDICATES = [
    "the review is positive",
    "the review praises the acting",
    "the review discusses the plot",
    "the review would recommend the movie",
]
# synthetic label keys backing the K standing queries (cycled)
LABEL_KEYS = ["RV-Q1", "RV-Q3", "RV-Q2"]


def build_watcher(args, device="cuda"):
    """Session + oracles + watcher over one deterministic stream."""
    dev = resolve_device(device)
    ds = make_dataset("imdb_review", n=args.n, seed=0)
    pol = ExecutionPolicy(n_clusters=4, min_sample=25)
    sess = Session(policy=pol, device=dev)
    store = SessionStore(args.state_dir)

    if args.engine:
        import torch

        from repro_torch.configs import smoke_config
        from repro_torch.core.oracle import ModelOracle
        from repro_torch.data import HashTokenizer
        from repro_torch.models import lm
        from repro_torch.serving import ServingEngine
        cfg = smoke_config(args.arch)
        if args.attn_impl:
            cfg = cfg.replace(attn_impl=args.attn_impl)
        params = lm.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        engine = ServingEngine(cfg, params, device=dev)
        tok = HashTokenizer(cfg.vocab_size)
        # the stream table starts EMPTY; ModelOracle indexes the table's
        # live texts list, which append() extends in place, so prompts
        # always see the rows the ids name.  The table copies the texts
        # it is given, so the oracle takes the table's list, not ours.
        handle = sess.table(
            texts=[], embeddings=np.zeros((0, ds.embeddings.shape[1]),
                                          np.float32), name="feed")
        preds = (WATCH_PREDICATES
                 * ((args.queries - 1) // len(WATCH_PREDICATES) + 1))
        for i in range(args.queries):
            sess.register_oracle(f"p{i}", ModelOracle(
                engine, tok, preds[i], handle._table.texts))
    else:
        for i in range(args.queries):
            key = LABEL_KEYS[i % len(LABEL_KEYS)]
            sess.register_oracle(f"p{i}", SyntheticOracle(
                ds.labels[key], flip_prob=0.0, seed=7 + i,
                token_lens=ds.token_lens))

    watcher = StreamWatcher(sess, table_name="feed", store=store,
                            tag="watch",
                            checkpoint_every=args.checkpoint_every)
    watcher.add_source(
        SyntheticSource("feed0", texts=list(ds.texts),
                        embeddings=ds.embeddings,
                        arrive_per_tick=args.arrive_per_tick, seed=11),
        RateBudget(rows_per_tick=args.rows_per_tick))
    sink_dir = pathlib.Path(args.state_dir)
    for i in range(args.queries):
        watcher.register(f"p{i}",
                         sink=JsonlSink(sink_dir / f"notify_p{i}.jsonl"))
    return sess, watcher


def main(argv=None, device="cuda"):
    """The CLI.  ``device`` is for in-process callers (tests pass
    ``"cpu"``); it is not a command-line flag.  Returns the watcher."""
    resolve_device(device)
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=400,
                    help="total rows in the replayed stream")
    ap.add_argument("--queries", type=int, default=3, metavar="K",
                    help="number of standing queries")
    ap.add_argument("--arrive-per-tick", type=int, default=40)
    ap.add_argument("--rows-per-tick", type=int, default=40,
                    help="per-source ingestion quota (arrivals beyond it "
                         "defer to later ticks, never drop)")
    ap.add_argument("--state-dir", default="/tmp/repro_watch_state",
                    help="SessionStore + sink + checkpoint directory")
    ap.add_argument("--checkpoint-every", type=int, default=2,
                    metavar="TICKS")
    ap.add_argument("--kill-after", type=int, default=0, metavar="K",
                    help="stop after tick K as if killed (checkpoint via "
                         "the shutdown path); rerun to restore mid-stream")
    ap.add_argument("--engine", action="store_true",
                    help="ModelOracle over the smoke backbone instead of "
                         "synthetic oracles")
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--attn-impl", default=None,
                    choices=["auto", "plain", "chunked", "tri", "flash",
                             "flash-ref"])
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
    ap.add_argument("--trace-dir", default=None, metavar="DIR")
    args = ap.parse_args(argv)

    registry = MetricsRegistry()
    tracer = None
    monitor = None
    flight = None
    hub = None
    if args.trace_dir or args.metrics_port or args.flight_dir:
        tracer = Tracer(metrics=registry)
        set_tracer(tracer)
        monitor = HealthMonitor(registry, rules=default_rules(),
                                sinks=[LogAlertSink("[watch][health]")])
        set_monitor(monitor)
    if args.flight_dir:
        flight = FlightRecorder(args.flight_dir, tracer=tracer,
                                registry=registry)
        flight.install()
        set_flight_recorder(flight)
        monitor.add_sink(flight.note_alert)
    if args.metrics_port:
        from repro_torch.launch.serve import start_metrics_server
        hub = StatusHub(monitor=monitor, flight=flight)
        start_metrics_server(registry, args.metrics_port,
                             host=args.metrics_host, hub=hub,
                             label="watch")

    sess, watcher = build_watcher(args, device)
    if hub is not None:
        hub.add_provider("stream", watcher.status_view)

    resumed = False
    if watcher.has_checkpoint():
        report = watcher.restore()
        resumed = True
        print(f"[watch] restored at tick {watcher.stats.n_ticks} "
              f"({watcher.stats.n_notifications} rows already notified, "
              f"0 oracle calls to rebuild): {report}")

    # flag-mode shutdown: the tick loop stops at a tick boundary, then the
    # watcher writes its final checkpoint and flushes every sink
    shutdown = GracefulShutdown(exit_on_signal=False).install()
    shutdown.register("watch-shutdown", watcher.shutdown)
    if flight is not None:
        flight.install(shutdown=shutdown)  # signal-triggered dumps only
    try:
        while not watcher.drained and not shutdown.requested:
            summary = watcher.tick()
            print(f"[watch] tick {summary['tick']}: +{summary['rows']} rows "
                  f"({summary['backlog']} deferred), "
                  f"{summary['oracle_calls']} oracle calls, "
                  f"{summary['notified']} notified")
            if args.kill_after and summary["tick"] >= args.kill_after:
                print(f"[watch] --kill-after {args.kill_after}: stopping "
                      "mid-stream (rerun to restore)")
                break
    finally:
        shutdown.close()   # runs watcher.shutdown() once, restores handlers
        sess.close()

    st = watcher.stats
    print(f"[watch] {'resumed ' if resumed else ''}done: {st.n_ticks} ticks, "
          f"{st.n_rows_ingested} rows ingested, "
          f"{st.n_oracle_calls} oracle calls, "
          f"{st.n_notifications} notifications "
          f"({sum(sq.runner.stats.n_deduped for sq in watcher.queries.values())}"
          f" deduped, "
          f"{sum(sq.runner.stats.n_dead_lettered for sq in watcher.queries.values())}"
          f" dead-lettered)")
    if tracer is not None and args.trace_dir:
        from repro_torch.launch.serve import export_trace
        export_trace(args.trace_dir, tracer, registry, watcher,
                     sess.scheduler.stats if sess._scheduler else None)
    return watcher


if __name__ == "__main__":
    main()
