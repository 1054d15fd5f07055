"""Service demo: N concurrent mixed queries + a restartable session.

    PYTHONPATH=src python -m repro_torch.examples.service_demo

Drives the concurrent semantic-filter service (repro_torch.service) end
to end:
one multi-tenant ``FilterService`` over a Session, six mixed queries —
single filters, an expression cascade, a negation, a semantic join, and a
replay — submitted concurrently so their per-round oracle batches merge
into cross-query dispatches; then the session is checkpointed to disk,
rebuilt "in a new process", and every query replays at zero oracle calls.
Asserts the service contracts inline (bit-identity to serial collects,
>= 1.5x merged batch size, 0-call reload replay).  The sessions' k-means
and votes run on the card (``main(device="cpu")`` for the CPU).
"""
import tempfile

import numpy as np

from repro_torch.api import ExecutionPolicy, Session
from repro_torch.core import SyntheticOracle
from repro_torch.data import make_dataset
from repro_torch.service import FilterService, TenantBudgetError
from repro_torch.utils.timing import monotonic

POL = ExecutionPolicy(n_clusters=4, xi=0.005)
N = 3000


def build_session(ds, dl, dr, pair_truth, device):
    """Session + registered tables/oracles (durable names -> restartable)."""
    sess = Session(policy=POL, device=device)
    sess.table(embeddings=ds.embeddings, name="reviews")
    sess.table(embeddings=dl.embeddings, name="L")
    sess.table(embeddings=dr.embeddings, name="R")
    # one oracle per predicate: concurrent queries over DISTINCT predicates
    # run fully overlapped; queries sharing a predicate (the replay below)
    # are conflict-serialized by the scheduler
    for name, q, seed in [("positive", "RV-Q1", 7), ("acting", "RV-Q3", 8),
                          ("plot", "RV-Q2", 9), ("long", "RV-Q1", 11),
                          ("noir", "RV-Q3", 12)]:
        sess.register_oracle(name, SyntheticOracle(
            ds.labels[q], flip_prob=0.02, seed=seed,
            token_lens=ds.token_lens))
    sess.register_oracle("same_topic", SyntheticOracle(
        pair_truth.ravel(), flip_prob=0.0, seed=3))
    return sess


ORACLES = ("positive", "acting", "plot", "long", "noir", "same_topic")


def workload(sess):
    t, tl, tr = sess["reviews"], sess["L"], sess["R"]
    return [
        ("filter positive", t.filter("positive")),
        ("filter acting", t.filter("acting")),
        ("cascade plot&long", t.filter("plot") & t.filter("long")),
        ("negation ~noir", ~t.filter("noir")),
        ("join L x R", tl.join(tr, sess.oracle("same_topic"))),
        ("replay positive", t.filter("positive")),   # conflict-serialized
    ]


def main(device="cuda"):
    print("== concurrent semantic-filter service demo (repro_torch.service) ==")
    ds = make_dataset("imdb_review", n=N, seed=0)
    dl = make_dataset("imdb_review", n=120, seed=1, n_topics=4)
    dr = make_dataset("imdb_review", n=90, seed=2, n_topics=4)
    pair_truth = (dl.topics[:, None] % 2) == (dr.topics[None, :] % 2)

    # ---- serial control: same queries, fresh session, one at a time ----
    serial_sess = build_session(ds, dl, dr, pair_truth, device)
    serial = [(label, q.collect()) for label, q in workload(serial_sess)]
    serial_batches = [b for name in ORACLES
                      for b in serial_sess.oracle(name).stats.batch_sizes]

    # ---- concurrent service: submit all six, gather once ----
    sess = build_session(ds, dl, dr, pair_truth, device)
    service = FilterService(sess)
    service.register_tenant("demo", POL.replace(max_oracle_calls=100_000))
    service.register_tenant("capped", POL.replace(max_oracle_calls=10))
    try:
        service.submit("capped", sess["reviews"].filter("positive"))
        raise AssertionError("capped tenant must be rejected")
    except TenantBudgetError as e:
        print(f"admission control: {e}")

    t0 = monotonic()
    with sess.scheduler.holding():   # merge from the very first round
        tickets = [service.submit("demo", q, label=label)
                   for label, q in workload(sess)]
    results = service.gather(*tickets)
    conc_wall = monotonic() - t0

    print(f"\n{'query':<20s} {'serial':>8s} {'service':>8s}  mask")
    for (label, rs), rc in zip(serial, results):
        same = ((rc.mask == rs.mask).all() if rs.mask is not None
                else (rc.pair_mask == rs.pair_mask).all())
        print(f"{label:<20s} {rs.n_llm_calls:>8d} {rc.n_llm_calls:>8d}  "
              f"{'identical' if same else 'DIFFERENT'}")
        assert same and rc.n_llm_calls == rs.n_llm_calls, label
    assert results[-1].n_llm_calls == 0, "resubmitted query must replay"

    merge = sess.scheduler.stats.merge
    ratio = merge.mean_batch_size / np.mean(serial_batches)
    print(f"\ncross-query batching: {merge.n_invocations} merged "
          f"dispatches, mean {merge.mean_batch_size:.0f} ids/invocation "
          f"vs {np.mean(serial_batches):.0f} serial "
          f"({ratio:.2f}x, merge factor {merge.merge_factor:.1f}); "
          f"gather wall {conc_wall:.2f}s")
    assert ratio >= 1.5, f"batching ratio {ratio:.2f} below 1.5x"
    acct = service.tenant("demo")
    print(f"tenant 'demo': spent {acct.spent} of {acct.budget} "
          f"({acct.n_admitted} queries)")

    # ---- restartable session: checkpoint, rebuild, 0-call replay ----
    with tempfile.TemporaryDirectory() as tmp:
        svc2 = FilterService(sess, store_dir=tmp)
        path = svc2.checkpoint()
        print(f"\ncheckpointed session state to {path.name}/")

        fresh = build_session(ds, dl, dr, pair_truth, device)  # "new process"
        restored = FilterService(fresh, store_dir=tmp)
        print(f"restore: {restored.restore()}")
        # 1000 calls: far below the cold run's worst case — replayable
        # leaves are budgeted at ~0, only the cascade's subset-restricted
        # second leaf (no full-table decision memo) reserves its estimate
        restored.register_tenant("demo", POL.replace(max_oracle_calls=1000))
        with fresh.scheduler.holding():
            tks = [restored.submit("demo", q, label=label)
                   for label, q in workload(fresh)]
        replays = restored.gather(*tks)
        total = sum(r.n_llm_calls for r in replays)
        for (label, rs), rr in zip(serial, replays):
            same = ((rr.mask == rs.mask).all() if rs.mask is not None
                    else (rr.pair_mask == rs.pair_mask).all())
            assert same and rr.n_llm_calls == 0, label
        print(f"reloaded session replayed all {len(replays)} queries at "
              f"{total} oracle calls (bit-identical; fits a 1000-call "
              "budget the 5000+-call cold run would blow)")
        restored.close()
    service.close()
    print("\nservice demo OK")
    return results


if __name__ == "__main__":
    main()
