"""Stream watcher demo: standing queries, kill/restart, exact delivery.

    PYTHONPATH=src python -m repro_torch.examples.watch_demo

Drives the streaming subsystem (repro_torch.stream) end to end: a
deterministic replayed feed arrives tick by tick under a per-source rate
budget, three standing queries re-vote only the clusters each tick's
appends touch, and every newly-matching row is pushed exactly once to its
sink.  Midway the watcher is killed (the graceful-shutdown path: final
checkpoint + sink flush) and restarted from the ``SessionStore``
checkpoint — the rebuild costs ~0 oracle calls and the remaining ticks
notify exactly what an unkilled control run notifies.  Asserts the stream
contracts inline (sublinear per-tick cost, zero duplicate notifications
across the kill/restart, zero-call restore).  The sessions' k-means
patches and votes run on the card (``main(device="cpu")`` for the CPU).
"""
import signal
import tempfile

from repro_torch.api import ExecutionPolicy, Session
from repro_torch.core import SyntheticOracle
from repro_torch.data import make_dataset
from repro_torch.service.lifecycle import GracefulShutdown
from repro_torch.service.store import SessionStore
from repro_torch.stream import (CallbackSink, RateBudget, StreamWatcher,
                                SyntheticSource)

POL = ExecutionPolicy(n_clusters=4, min_sample=25)
N = 500
PER_TICK = 50
KILL_AFTER = 4
QUERIES = [("positive", "RV-Q1", 7), ("acting", "RV-Q3", 8),
           ("plot", "RV-Q2", 9)]


def build(ds, state_dir, device):
    """Session + oracles + watcher over the same deterministic stream
    (durable oracle names -> the checkpoint is restorable)."""
    sess = Session(policy=POL, device=device)
    for name, key, seed in QUERIES:
        sess.register_oracle(name, SyntheticOracle(
            ds.labels[key], flip_prob=0.0, seed=seed,
            token_lens=ds.token_lens))
    store = SessionStore(state_dir) if state_dir else None
    watcher = StreamWatcher(sess, table_name="feed", store=store)
    watcher.add_source(
        SyntheticSource("feed0", texts=list(ds.texts),
                        embeddings=ds.embeddings,
                        arrive_per_tick=PER_TICK, seed=11),
        RateBudget(rows_per_tick=PER_TICK))
    events = {}
    for name, _, _ in QUERIES:
        lst = events.setdefault(name, [])
        watcher.register(name, sink=CallbackSink(
            (lambda L: lambda ev: L.append(ev))(lst)))
    return sess, watcher, events


def main(device="cuda"):
    print("== stream watcher demo (repro_torch.stream) ==")
    ds = make_dataset("imdb_review", n=N, seed=0)

    # ---- control: full run, never killed -------------------------------
    sess_c, w_c, ev_c = build(ds, None, device)
    ticks_c = w_c.run()
    n_total = sum(len(v) for v in ev_c.values())
    print(f"control: {len(ticks_c)} ticks, "
          f"{w_c.stats.n_oracle_calls} oracle calls, "
          f"{n_total} notifications")
    # sublinear: steady-state ticks pay for their own rows, not the table
    per_tick = [t["oracle_calls"] for t in ticks_c]
    assert all(c <= PER_TICK * len(QUERIES) for c in per_tick[1:]), per_tick
    sess_c.close()

    with tempfile.TemporaryDirectory() as tmp:
        # ---- leg 1: run to tick KILL_AFTER, then a SIGTERM-style kill --
        sess_a, w_a, ev_a = build(ds, tmp, device)
        shutdown = GracefulShutdown(exit_on_signal=False).install()
        shutdown.register("watch-shutdown", w_a.shutdown)
        for _ in range(KILL_AFTER):
            s = w_a.tick()
            print(f"tick {s['tick']}: +{s['rows']} rows, "
                  f"{s['oracle_calls']} oracle calls, "
                  f"{s['notified']} notified")
        shutdown.trigger(signal.SIGTERM)   # checkpoint + flush, once
        shutdown.close()
        sess_a.close()
        print(f"killed after tick {KILL_AFTER} "
              f"({sum(len(v) for v in ev_a.values())} rows notified so far)")

        # ---- leg 2: fresh process restores mid-stream ------------------
        sess_b, w_b, ev_b = build(ds, tmp, device)
        assert w_b.has_checkpoint()
        report = w_b.restore()
        assert sess_b.stats.n_calls == 0, "restore must not re-invoke"
        print(f"restored at tick {w_b.stats.n_ticks} at 0 oracle calls: "
              f"{report}")
        ticks_b = w_b.run()
        sess_b.close()

    # ---- the kill/restart contracts ------------------------------------
    for name, _, _ in QUERIES:
        ctl_tail = [(e["tick"], e["row"]) for e in ev_c[name]
                    if e["tick"] > KILL_AFTER]
        got_tail = [(e["tick"], e["row"]) for e in ev_b[name]]
        assert got_tail == ctl_tail, f"{name}: tail diverged from control"
        keys = ([e["key"] for e in ev_a[name]]
                + [e["key"] for e in ev_b[name]])
        assert len(keys) == len(set(keys)), f"{name}: duplicate across kill"
        assert sorted(keys) == sorted(e["key"] for e in ev_c[name]), name
    assert ([t["oracle_calls"] for t in ticks_b]
            == [t["oracle_calls"] for t in ticks_c[KILL_AFTER:]])
    print(f"restart leg: {len(ticks_b)} ticks notified exactly the "
          "control's rows — zero duplicates, zero drops")
    print("\nwatch demo OK")
    return ticks_c, ticks_b


if __name__ == "__main__":
    main()
