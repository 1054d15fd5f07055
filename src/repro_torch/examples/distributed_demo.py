"""Distributed execution demo: sharded rounds + append-only session log.

    PYTHONPATH=src python -m repro_torch.examples.distributed_demo

Three acts, each asserting its contract inline (CI runs this as smoke):

1. **Sharded rounds** — a two-shard CSV round over the Fig. 4-sized imdb
   table: masks, oracle call counts, and cluster logs are bit-identical
   to the single-host run; only per-dispatch batch sizes shrink.
2. **Merged dispatch lane** — two Sessions (stand-ins for two scheduler
   processes) feed ONE dispatch lane through a ``DispatchCoordinator``,
   again bit-identical to serial collects.
3. **Continuous checkpointing** — a ``FilterService`` on an append-only
   session log (``log_dir``): every decision is durable the moment it is
   made, the "process" dies without a final checkpoint, and the restart
   replays snapshot + log tail to the same masks at zero oracle calls.

Every session's k-means and votes run on the card
(``main(device="cpu")`` for the CPU).
"""
import tempfile

from repro_torch.api import ExecutionPolicy, Session
from repro_torch.core import CSVConfig, SyntheticOracle, semantic_filter
from repro_torch.data import make_dataset
from repro_torch.distributed import DispatchCoordinator
from repro_torch.service import FilterService

N = 3000
POL = ExecutionPolicy(n_clusters=4, xi=0.005)


def _oracle(ds, key="RV-Q1", seed=7):
    return SyntheticOracle(ds.labels[key], flip_prob=0.02, seed=seed,
                           token_lens=ds.token_lens)


def act1_sharded_rounds(ds, device):
    print("== act 1: two-shard rounds, bit-identical to single-host ==")
    runs = {}
    for shards in (1, 2):
        r = semantic_filter(ds.embeddings, _oracle(ds),
                            CSVConfig(n_clusters=4, xi=0.005,
                                      shards=shards),
                            device=device)
        runs[shards] = r
        batches = [b for rr in r.round_log for b in rr.oracle_batches]
        print(f"  shards={shards}: {r.n_llm_calls} oracle calls, "
              f"{len(r.round_log)} rounds, batches={batches}")
    r1, r2 = runs[1], runs[2]
    assert (r1.mask == r2.mask).all(), "masks diverged"
    assert r1.n_llm_calls == r2.n_llm_calls, "call counts diverged"
    assert r1.cluster_log == r2.cluster_log, "cluster logs diverged"
    assert any(rr.shards == 2 for rr in r2.round_log), "never sharded"
    print("  bit-identity holds: masks, calls, cluster logs all equal\n")


def act2_coordinator(ds, device):
    print("== act 2: two schedulers, one merged dispatch lane ==")
    serial = {}
    for q in ("RV-Q1", "RV-Q3"):
        s = Session(policy=POL, device=device)
        t = s.table(embeddings=ds.embeddings, name="reviews")
        serial[q] = t.filter(_oracle(ds, q), name="q").collect()
        s.close()
    coord = DispatchCoordinator()
    try:
        sessions, tickets = [], []
        for q in ("RV-Q1", "RV-Q3"):
            s = Session(policy=POL, coordinator=coord, device=device)
            t = s.table(embeddings=ds.embeddings, name="reviews")
            with s.scheduler.holding():
                tickets.append((q, s.scheduler.submit(
                    t.filter(_oracle(ds, q), name="q"))))
            sessions.append(s)
        for q, tk in tickets:
            r = tk.result()
            assert (r.mask == serial[q].mask).all(), f"{q}: mask diverged"
            assert r.n_llm_calls == serial[q].n_llm_calls
        print(f"  lanes attached: {coord.n_attached}; per-lane waves: "
              f"{[ls.n_waves for ls in coord.stats().values()]}")
        for s in sessions:
            s.close()
        assert coord.n_attached == 0, "lanes leaked after session close"
    finally:
        coord.close()
    print("  both sessions' masks/calls equal their serial controls\n")


def act3_continuous_checkpoint(ds, log_dir, device):
    print("== act 3: append-only log — crash, restart, replay ==")

    def build():
        s = Session(policy=POL.replace(shards=2, log_dir=log_dir,
                                       log_compact_records=6),
                    device=device)
        t = s.table(embeddings=ds.embeddings, name="reviews")
        s.register_oracle("positive", _oracle(ds, "RV-Q1", 7))
        s.register_oracle("acting", _oracle(ds, "RV-Q3", 8))
        svc = FilterService(s)
        svc.register_tenant("demo", s.policy)
        return s, t, svc

    s1, t1, svc1 = build()
    svc1.restore()                       # fresh dir: starts recording
    (rp,) = svc1.gather(svc1.submit("demo", t1.filter("positive")))
    (ra,) = svc1.gather(svc1.submit("demo", t1.filter("acting")))
    gens = svc1.log._gen
    print(f"  live: positive={rp.n_llm_calls} calls, "
          f"acting={ra.n_llm_calls} calls; log generation {gens} "
          f"(compaction thresholds crossed mid-run)")
    svc1.log.abandon()                   # kill -9: no close, no snapshot
    s1.close()

    s2, t2, svc2 = build()
    rep = svc2.restore()
    print(f"  restart: {rep}")
    (rp2,) = svc2.gather(svc2.submit("demo", t2.filter("positive")))
    (ra2,) = svc2.gather(svc2.submit("demo", t2.filter("acting")))
    assert (rp2.mask == rp.mask).all() and (ra2.mask == ra.mask).all()
    assert rp2.n_llm_calls == 0 and ra2.n_llm_calls == 0, \
        "restart should replay, not recompute"
    assert s2.stats.n_calls == 0
    print(f"  replayed both filters at 0 oracle calls "
          f"({rp2.n_replayed} + {ra2.n_replayed} decisions from the log)")
    svc2.close()


def main(device="cuda"):
    ds = make_dataset("imdb_review", n=N, seed=0)
    act1_sharded_rounds(ds, device)
    act2_coordinator(ds, device)
    with tempfile.TemporaryDirectory() as d:
        act3_continuous_checkpoint(ds, d, device)
    print("\ndistributed demo OK")


if __name__ == "__main__":
    main()
