"""The port's concurrent service against the JAX reference, on the CPU.

The cases of tests/test_service.py on ``repro_torch.service`` (interleaved
submits equal to serial collects with merged batches, conflict
serialisation, failure isolation, ``SessionStore`` round trips at zero
oracle calls, dirty-cluster re-votes after a reload, store invalidation,
tenant admission and settlement), the coordinator cases of
tests/test_distributed_round.py, the idle scheduler and the graceful
shutdown.  Each runs the same calls through ``repro.api``/``repro.service``
and ``repro_torch.api``/``repro_torch.service`` (``device="cpu"``, the
reference's k-means++ injected through ``init_centroids``) and requires
equal masks, call counts and ``oracle_batch_sizes``.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import api as japi
from repro import service as jservice
from repro.core import clustering as jc
from repro.core.oracle import SyntheticOracle as JSyntheticOracle
from repro.data import make_dataset
from repro.distributed import DispatchCoordinator as JDispatchCoordinator
from repro_torch import api as tapi
from repro_torch import service as tservice
from repro_torch.core.oracle import SyntheticOracle
from repro_torch.distributed import DispatchCoordinator
from repro_torch.service.lifecycle import GracefulShutdown

N = 1200
_plusplus = jax.jit(jc._plusplus_init, static_argnums=2)


def jax_seeder(seed, x, k):
    return np.asarray(_plusplus(jax.random.key(seed), jnp.asarray(x), k))


SIDES = {"ref": (japi, JSyntheticOracle, jservice, JDispatchCoordinator),
         "port": (tapi, SyntheticOracle, tservice, DispatchCoordinator)}


@pytest.fixture(scope="module")
def ds():
    return make_dataset("imdb_review", n=N, seed=0)


@pytest.fixture(scope="module")
def join_sides():
    dl = make_dataset("imdb_review", n=80, seed=1, n_topics=4)
    dr = make_dataset("imdb_review", n=60, seed=2, n_topics=4)
    truth = (dl.topics[:, None] % 2) == (dr.topics[None, :] % 2)
    return dl, dr, truth


def _pol(side, **kw):
    return SIDES[side][0].ExecutionPolicy(**{"n_clusters": 4, "xi": 0.005,
                                             **kw})


def _session(side, policy=None, **kw):
    policy = policy or _pol(side)
    if side == "ref":
        return japi.Session(policy=policy, **kw)
    return tapi.Session(policy=policy, init_centroids=jax_seeder,
                        device="cpu", **kw)


def _oracle(side, labels, flip=0.02, seed=7, token_lens=None):
    return SIDES[side][1](labels, flip_prob=flip, seed=seed,
                          token_lens=token_lens)


def _q(side, ds, q="RV-Q1", seed=7):
    return _oracle(side, ds.labels[q], seed=seed, token_lens=ds.token_lens)


def _both(fn):
    out = {side: fn(side) for side in SIDES}
    assert _plain(out["port"]) == _plain(out["ref"])
    return out["port"]


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.integer, np.bool_)):
        return x.item()
    return x


def _result(r):
    """A QueryResult's decisions and counts (no wall times)."""
    return (r.mask if r.mask is not None else r.pair_mask, r.n_llm_calls,
            r.pilot_calls, r.n_replayed)


def _blobs(n_per=300, k=4, seed=0):
    rng = np.random.default_rng(seed)
    centers = np.eye(k, k, dtype=np.float32) * 10.0
    emb = np.concatenate([
        centers[i] + rng.normal(0, 0.5, (n_per, k)).astype(np.float32)
        for i in range(k)])
    labels = np.concatenate([np.full(n_per, bool(i % 2 == 0))
                             for i in range(k)])
    return centers, emb, labels


def _mixed_workload(side, ds, join_sides):
    dl, dr, truth = join_sides
    sess = _session(side)
    t = sess.table(embeddings=ds.embeddings, name="reviews")
    tl = sess.table(embeddings=dl.embeddings, name="L")
    tr = sess.table(embeddings=dr.embeddings, name="R")
    jo = _oracle(side, truth.ravel(), flip=0.0, seed=3)
    queries = [
        t.filter(_q(side, ds, "RV-Q1"), name="A"),
        t.filter(_q(side, ds, "RV-Q3"), name="B"),
        t.filter(_q(side, ds, "RV-Q1", seed=11), name="C")
        & t.filter(_q(side, ds, "RV-Q3", seed=12), name="D"),
        ~t.filter(_q(side, ds, "RV-Q3", seed=13), name="E"),
        tl.join(tr, jo),
    ]
    return sess, queries


def _leaf_oracles(q):
    return q._oracles() if hasattr(q, "_oracles") else [q.oracle]


# ------------------------------------------------- concurrency determinism
def test_interleaved_submits_match_serial_collects(ds, join_sides):
    def run(side):
        s_serial, qs = _mixed_workload(side, ds, join_sides)
        serial = [q.collect() for q in qs]
        serial_batches = [b for q in qs for o in _leaf_oracles(q)
                          for b in o.stats.batch_sizes]
        s_conc, qc = _mixed_workload(side, ds, join_sides)
        try:
            with s_conc.scheduler.holding():
                tickets = [s_conc.submit(q) for q in qc]
            conc = s_conc.gather(*tickets)
            for rs, rc in zip(serial, conc):
                assert _plain(_result(rc)) == _plain(_result(rs))
            assert s_conc.stats.n_calls == s_serial.stats.n_calls
            assert s_conc.stats.input_tokens == s_serial.stats.input_tokens
            merge = s_conc.scheduler.stats.merge
            ratio = merge.mean_batch_size / np.mean(serial_batches)
            assert ratio >= 1.5, f"mean merged batch only {ratio:.2f}x"
            assert merge.merge_factor > 1.5
            conc_batches = [[o.stats.batch_sizes for o in _leaf_oracles(q)]
                            for q in qc]
        finally:
            s_conc.close()
        return ([_result(r) for r in conc], conc_batches,
                merge.n_invocations, merge.total_ids)
    _both(run)


def test_submit_does_not_perturb_later_serial_collect(ds):
    def run(side):
        sess = _session(side)
        q = sess.table(embeddings=ds.embeddings).filter(_q(side, ds),
                                                        name="A")
        try:
            (r1,) = sess.gather(sess.submit(q))
            r2 = q.collect()
            assert r2.n_llm_calls == 0 and r2.n_replayed == N
            assert (r2.mask == r1.mask).all()
        finally:
            sess.close()
        return _result(r1), _result(r2)
    _both(run)


def test_conflicting_submissions_serialize_and_replay(ds):
    def run(side):
        sess = _session(side)
        t = sess.table(embeddings=ds.embeddings)
        o = _q(side, ds)
        try:
            with sess.scheduler.holding():
                k1 = sess.submit(t.filter(o, name="A"))
                k2 = sess.submit(t.filter(o, name="A"))
            r1, r2 = sess.gather(k1, k2)
            assert sess.scheduler.stats.n_deferred == 1
            assert r1.n_llm_calls > 0
            assert r2.n_llm_calls == 0 and r2.n_replayed == N
            assert (r2.mask == r1.mask).all()
            assert o.stats.n_calls == r1.n_llm_calls
        finally:
            sess.close()
        return _result(r1), _result(r2), o.stats.batch_sizes
    _both(run)


def test_failed_query_does_not_wedge_the_scheduler(ds):
    class Boom(RuntimeError):
        pass

    def run(side):
        class FailingOracle(SIDES[side][1]):
            def _evaluate(self, ids):
                raise Boom("oracle down")

        sess = _session(side)
        t = sess.table(embeddings=ds.embeddings)
        bad = FailingOracle(ds.labels["RV-Q1"])
        try:
            with sess.scheduler.holding():
                kb = sess.submit(t.filter(bad, name="bad"))
                kg = sess.submit(t.filter(_q(side, ds), name="good"))
            with pytest.raises(Boom):
                kb.result()
            (rg,) = sess.gather(kg)
            assert rg.n_llm_calls > 0
            ref = _session(side).table(embeddings=ds.embeddings).filter(
                _q(side, ds), name="good").collect()
            assert (rg.mask == ref.mask).all()
            assert sess.scheduler.stats.n_failed == 1
        finally:
            sess.close()
        return _result(rg)
    _both(run)


def test_result_under_hold_raises_instead_of_deadlocking(ds):
    sess = _session("port")
    t = sess.table(embeddings=ds.embeddings)
    try:
        with sess.scheduler.holding():
            tk = sess.submit(t.filter(_q("port", ds), name="A"))
            with pytest.raises(RuntimeError, match="holding"):
                tk.result(timeout=5)
            with pytest.raises(RuntimeError, match="holding"):
                sess.gather(tk)
        (r,) = sess.gather(tk)
        assert r.n_llm_calls > 0
    finally:
        sess.close()


def test_idle_scheduler_does_no_dispatch_work(ds):
    """Between bursts the loop thread parks: no dispatch ticks while idle,
    and the idle flag is set whenever nothing is in flight."""
    sess = _session("port")
    t = sess.table(embeddings=ds.embeddings)
    try:
        sched = sess.scheduler
        assert sched.idle.is_set()
        (r,) = sess.gather(sess.submit(t.filter(_q("port", ds), name="A")))
        assert sched.idle.wait(timeout=30)
        ticks = sched.stats.n_dispatch_ticks
        assert ticks > 0 and r.n_llm_calls > 0
        time.sleep(0.2)
        assert sched.stats.n_dispatch_ticks == ticks
        view = sched.status_view()
        assert view["in_flight"] == 0 and view["completed"] == 1
    finally:
        sess.close()


def test_many_threads_count_every_launch(monkeypatch):
    """The kernel launch counter is locked: concurrent increments from
    more threads than cores lose none (a short switch interval forces
    interleaving)."""
    import sys

    from repro_torch.kernels import build

    def wrapper():
        pass
    wrapper.launches = 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [build.count_launch(wrapper)
                            for _ in range(2000)]) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    assert wrapper.launches == 16 * 2000


# -------------------------------------------------------------- persistence
def _persist_session(side, ds, join_sides):
    dl, dr, truth = join_sides
    sess = _session(side)
    t = sess.table(embeddings=ds.embeddings, name="reviews")
    tl = sess.table(embeddings=dl.embeddings, name="L")
    tr = sess.table(embeddings=dr.embeddings, name="R")
    sess.register_oracle("A", _q(side, ds, "RV-Q1"))
    sess.register_oracle("B", _q(side, ds, "RV-Q3"))
    sess.register_oracle("J", _oracle(side, truth.ravel(), flip=0.0, seed=3))
    return sess, t, tl, tr


def test_persistence_roundtrip_zero_call_replay(ds, join_sides, tmp_path):
    def run(side):
        sess, t, tl, tr = _persist_session(side, ds, join_sides)
        rA = t.filter("A").collect()
        rB0 = t.filter("B").collect()
        rB = (t.filter("A") & t.filter("B")).collect()
        rJ = tl.join(tr, sess.oracle("J")).collect()
        store = SIDES[side][2].SessionStore(tmp_path / side)
        store.save(sess)

        sess2, t2, tl2, tr2 = _persist_session(side, ds, join_sides)
        rep = store.load(sess2)
        assert set(rep.tables) == {"reviews", "L", "R"}
        assert rep.n_decisions >= 2 and rep.n_joins == 1 and not rep.skipped
        r2A = t2.filter("A").collect()
        assert r2A.n_llm_calls == 0 and r2A.n_replayed == N
        assert (r2A.mask == rA.mask).all()
        r2B0 = t2.filter("B").collect()
        assert r2B0.n_llm_calls == 0 and (r2B0.mask == rB0.mask).all()
        r2B = (t2.filter("A") & t2.filter("B")).collect()
        assert r2B.n_llm_calls == 0 and (r2B.mask == rB.mask).all()
        r2J = tl2.join(tr2, sess2.oracle("J")).collect()
        assert r2J.n_llm_calls == 0
        assert r2J.n_replayed == r2J.pair_mask.size
        assert (r2J.pair_mask == rJ.pair_mask).all()
        assert sess2.stats.n_calls == 0
        return ([_result(r) for r in (rA, rB0, rB, rJ)], str(rep))
    _both(run)


def test_store_files_cross_packages(ds, join_sides, tmp_path):
    """A snapshot the reference saved loads into the port and replays at
    zero calls with the reference's masks, and the other way round."""
    for writer, reader in (("ref", "port"), ("port", "ref")):
        sess, t, tl, tr = _persist_session(writer, ds, join_sides)
        rA = t.filter("A").collect()
        rJ = tl.join(tr, sess.oracle("J")).collect()
        SIDES[writer][2].SessionStore(tmp_path / writer).save(sess)
        sess2, t2, tl2, tr2 = _persist_session(reader, ds, join_sides)
        rep = SIDES[reader][2].SessionStore(tmp_path / writer).load(sess2)
        assert not rep.skipped and rep.n_decisions == 1 and rep.n_joins == 1
        r2A = t2.filter("A").collect()
        r2J = tl2.join(tr2, sess2.oracle("J")).collect()
        assert r2A.n_llm_calls == r2J.n_llm_calls == 0
        np.testing.assert_array_equal(r2A.mask, rA.mask)
        np.testing.assert_array_equal(r2J.pair_mask, rJ.pair_mask)


def test_reload_then_append_revotes_only_dirty_clusters(tmp_path):
    centers, emb, labels = _blobs()
    add = centers[0] + np.random.default_rng(9).normal(
        0, 0.5, (40, 4)).astype(np.float32)
    post_labels = np.concatenate([labels, np.full(40, True)])

    def run(side):
        def build():
            s = _session(side)
            t = s.table(embeddings=emb, name="blobs")
            s.register_oracle("P", _oracle(side, post_labels, flip=0.0))
            return s, t

        s1, t1 = build()
        r1 = t1.filter("P").collect()
        SIDES[side][2].SessionStore(tmp_path / side).save(s1)
        s2, t2 = build()
        rep = SIDES[side][2].SessionStore(tmp_path / side).load(s2)
        assert rep.tables == ["blobs"] and not rep.skipped
        t2.append(embeddings=add)
        r2 = t2.filter("P").collect()
        assert r2.n_replayed == 900
        assert 0 < r2.n_llm_calls < r1.n_llm_calls
        assert (r2.mask[: len(labels)] == r1.mask).all()
        s3, t3 = build()
        t3.filter("P").collect()
        t3.append(embeddings=add)
        rc = t3.filter("P").collect()
        assert rc.n_llm_calls == r2.n_llm_calls
        assert (rc.mask == r2.mask).all()
        return _result(r1), _result(r2)
    _both(run)


def test_store_invalidates_on_changed_table(ds, tmp_path):
    def run(side):
        sess = _session(side)
        t = sess.table(embeddings=ds.embeddings, name="reviews")
        sess.register_oracle("A", _q(side, ds))
        t.filter("A").collect()
        store = SIDES[side][2].SessionStore(tmp_path / side)
        store.save(sess)
        other = np.asarray(ds.embeddings).copy()
        other[0] += 1.0
        sess2 = _session(side)
        sess2.table(embeddings=other, name="reviews")
        sess2.register_oracle("A", _q(side, ds))
        rep = store.load(sess2)
        assert rep.tables == [] and rep.n_decisions == 0
        assert any("content changed" in s for s in rep.skipped)
        with pytest.raises(ValueError, match="content changed"):
            store.load(sess2, strict=True)
        return rep.skipped
    _both(run)


def test_store_invalidates_on_reencoded_texts(ds, tmp_path):
    texts = [f"review number {i}" for i in range(N)]

    def run(side):
        sess = _session(side)
        sess.table(texts=texts, embeddings=ds.embeddings, name="reviews")
        sess.register_oracle("A", _q(side, ds))
        sess["reviews"].filter("A").collect()
        SIDES[side][2].SessionStore(tmp_path / side).save(sess)
        sess2 = _session(side)
        sess2.table(texts=texts, embeddings=ds.embeddings * 0.5,
                    name="reviews")
        sess2.register_oracle("A", _q(side, ds))
        rep = SIDES[side][2].SessionStore(tmp_path / side).load(sess2)
        assert rep.tables == [] and rep.n_decisions == 0
        assert any("content changed" in s for s in rep.skipped)
        return rep.skipped
    _both(run)


def test_store_skips_unregistered_oracles(ds, tmp_path):
    def run(side):
        sess = _session(side)
        t = sess.table(embeddings=ds.embeddings, name="reviews")
        t.filter(_q(side, ds), name="anon").collect()
        store = SIDES[side][2].SessionStore(tmp_path / side)
        store.save(sess)
        sess2 = _session(side)
        sess2.table(embeddings=ds.embeddings, name="reviews")
        rep = store.load(sess2)
        assert rep.n_decisions == 0 and rep.tables == ["reviews"]
        return str(rep)
    _both(run)


# ---------------------------------------------------------------- admission
def test_tenant_admission_and_settlement(ds):
    def run(side):
        sess = _session(side)
        t = sess.table(embeddings=ds.embeddings)
        svc = SIDES[side][2].FilterService(sess)
        svc.register_tenant("small", _pol(side, max_oracle_calls=100))
        svc.register_tenant("big", _pol(side, max_oracle_calls=50_000))
        try:
            with pytest.raises(SIDES[side][2].TenantBudgetError):
                svc.submit("small", t.filter(_q(side, ds), name="S"))
            assert svc.tenant("small").n_rejected == 1
            o = _q(side, ds)
            (r,) = svc.gather(svc.submit("big", t.filter(o, name="A")))
            acct = svc.tenant("big")
            assert acct.spent == r.n_llm_calls > 0
            assert acct.reserved == 0.0
            tk2 = svc.submit("big", t.filter(o, name="A"),
                             policy=_pol(side, max_oracle_calls=50))
            (r2,) = svc.gather(tk2)
            assert r2.n_llm_calls == 0 and acct.spent == r.n_llm_calls
            view = svc.status_view()
        finally:
            svc.close()
        return _result(r), view
    _both(run)


def test_settlement_rides_on_completion_not_gather(ds):
    class Boom(RuntimeError):
        pass

    sess = _session("port")
    t = sess.table(embeddings=ds.embeddings)
    svc = tservice.FilterService(sess)
    svc.register_tenant("t", _pol("port", max_oracle_calls=2000))

    class FailingOracle(SyntheticOracle):
        def _evaluate(self, ids):
            raise Boom("oracle down")

    try:
        bad = svc.submit("t", t.filter(FailingOracle(ds.labels["RV-Q1"]),
                                       name="bad"))
        with pytest.raises(Boom):
            bad.result(timeout=60)
        acct = svc.tenant("t")
        deadline = 60.0
        while acct.reserved and deadline > 0:   # done-callback settles
            time.sleep(0.01)
            deadline -= 0.01
        assert acct.reserved == 0.0 and acct.spent == 0
        ok = svc.submit("t", t.filter(_q("port", ds), name="ok"))
        (r,) = svc.gather()
        assert r is not None and r.n_llm_calls > 0
        assert ok.done()
    finally:
        svc.close()


def test_unknown_tenant_rejected(ds):
    sess = _session("port")
    t = sess.table(embeddings=ds.embeddings)
    svc = tservice.FilterService(sess)
    with pytest.raises(KeyError, match="unknown tenant"):
        svc.submit("ghost", t.filter(_q("port", ds), name="A"))
    with pytest.raises(ValueError, match="not both"):
        tservice.FilterService(sess, store_dir="a", log_dir="b")


# ------------------------------------------------------------- coordinator
def test_coordinator_merges_lanes_bit_identically(ds):
    """Several schedulers feeding ONE dispatch lane: the serial masks and
    calls, lanes accounted, detach on session close."""
    def run(side):
        def serial(query):
            sess = _session(side)
            t = sess.table(embeddings=ds.embeddings, name="reviews")
            r = t.filter(_q(side, ds, query), name="q").collect()
            sess.close()
            return r

        coord = SIDES[side][3]()
        try:
            sessions, tickets, want = [], [], []
            for query in ("RV-Q1", "RV-Q3"):
                sess = _session(side, coordinator=coord)
                t = sess.table(embeddings=ds.embeddings, name="reviews")
                with sess.scheduler.holding():
                    tickets.append(sess.scheduler.submit(
                        t.filter(_q(side, ds, query), name="q")))
                sessions.append(sess)
                want.append(serial(query))
            got = [tk.result() for tk in tickets]
            for r, w in zip(got, want):
                assert (r.mask == w.mask).all()
                assert r.n_llm_calls == w.n_llm_calls
            assert coord.n_attached == 2
            stats = coord.stats()
            assert len(stats) == 2
            assert all(ls.n_waves > 0 for ls in stats.values())
            for sess in sessions:
                sess.close()
            assert coord.n_attached == 0
        finally:
            coord.close()
        return [_result(r) for r in got]
    _both(run)


def test_coordinator_lane_rejects_use_after_close():
    coord = DispatchCoordinator()
    try:
        lane = coord.attach(label="x")
        lane.close()
        lane.close()  # idempotent
        with pytest.raises(RuntimeError):
            lane.submit_call(lambda: None)
    finally:
        coord.close()
    with pytest.raises(RuntimeError, match="closed"):
        coord.attach()


def test_kill_mid_run_restart_replays_from_log(tmp_path):
    """Crash after some queries completed: restart = snapshot + log tail,
    and the completed work replays at 0 oracle calls without k-means."""
    ds = make_dataset("imdb_review", n=3000, seed=0)

    def run(side):
        d = tmp_path / side

        def build():
            sess = _session(side, policy=_pol(
                side, shards=2, log_dir=str(d), log_compact_records=4))
            t = sess.table(embeddings=ds.embeddings, name="reviews")
            sess.register_oracle("A", _q(side, ds, "RV-Q1"))
            sess.register_oracle("B", _q(side, ds, "RV-Q3"))
            svc = SIDES[side][2].FilterService(sess)
            svc.register_tenant("t0", sess.policy)
            return sess, t, svc

        sess1, t1, svc1 = build()
        assert svc1.restore() is None   # fresh dir: nothing to replay
        (rA,) = svc1.gather(svc1.submit("t0", t1.filter("A")))
        (rB,) = svc1.gather(svc1.submit("t0", t1.filter("B")))
        assert svc1.log._gen >= 1       # thresholds forced a compaction
        svc1.log.abandon()              # kill -9: no close, no snapshot
        sess1.close()

        sess2, t2, svc2 = build()
        rep = svc2.restore()
        assert rep is not None and rep.n_dropped == 0
        assert rep.snapshot is not None
        assert sess2._assign_cache or t2._table._assign_cache
        (r2A,) = svc2.gather(svc2.submit("t0", t2.filter("A")))
        (r2B,) = svc2.gather(svc2.submit("t0", t2.filter("B")))
        assert (r2A.mask == rA.mask).all() and (r2B.mask == rB.mask).all()
        assert r2A.n_llm_calls == 0 and r2B.n_llm_calls == 0
        assert sess2.stats.n_calls == 0
        svc2.close()
        return _result(rA), _result(rB), svc1.log._gen
    _both(run)


# ------------------------------------------------------------- lifecycle
def test_graceful_shutdown_runs_cleanups_once_in_order():
    done = []
    gs = GracefulShutdown(exit_on_signal=False)
    gs.register("a", lambda: done.append("a"))
    gs.register("boom", lambda: 1 / 0)   # a failing cleanup does not block
    gs.register("b", lambda: done.append("b"))
    with gs:
        gs.trigger()
        gs.trigger()
    assert done == ["a", "b"] and gs.requested


# ------------------------------------------------------------ checkpoint
def test_checkpoint_files_match_reference(tmp_path):
    """The port's save_pytree writes the reference's manifest and shard
    (keys in jax.tree_util order, dtypes, checksums, records), and each
    package loads the other's; a CheckpointManager round trip restores
    tensors onto a template's dtypes and devices."""
    import json

    import msgpack
    import torch

    from repro.checkpoint import load_pytree as j_load
    from repro.checkpoint import save_pytree as j_save
    from repro_torch.checkpoint import (CheckpointManager, load_pytree,
                                        save_pytree)
    from repro_torch.checkpoint.manager import _decompress

    rng = np.random.default_rng(0)
    tree = {"b": [rng.normal(size=(3, 2)).astype(np.float32), None,
                  (np.arange(4), np.array(True))],
            "a": {"z": np.zeros(0, np.int8), "y": rng.integers(0, 9, 5)},
            "c/d": np.float64(2.5)}
    for name, save in (("port", save_pytree), ("ref", j_save)):
        save(tree, tmp_path / name, extra_meta={"k": 1}, codec="zlib")

    def files(name):
        man = json.loads((tmp_path / name / "MANIFEST.json").read_text())
        man.pop("created")
        shard = tmp_path / name / "shard_000.msgpack.zlib"
        return man, msgpack.unpackb(_decompress(shard.read_bytes(), "zlib"))
    assert files("port") == files("ref")
    for load in (load_pytree, j_load):
        for name in ("port", "ref"):
            flat, extra = load(tmp_path / name)
            assert extra == {"k": 1}
            assert list(flat) == ["a/y", "a/z", "b/0", "b/2/0", "b/2/1",
                                  "c/d"]
            np.testing.assert_array_equal(flat["b/0"], tree["b"][0])

    mgr = CheckpointManager(tmp_path / "mgr", keep=2)
    params = {"w": torch.randn(4, 3).to(torch.bfloat16),
              "layers": [{"s": torch.ones(3)}, {"s": torch.zeros(3)}]}
    for step in (1, 2, 3):
        mgr.save(step, params, extra_meta={"note": "x"})
    assert mgr.latest_step() == 3
    assert sorted(p.name for p in (tmp_path / "mgr").iterdir()) == [
        "step_00000002", "step_00000003"]
    template = {"w": torch.zeros(4, 3, dtype=torch.bfloat16),
                "layers": [{"s": torch.zeros(3)}, {"s": torch.zeros(3)}]}
    step, got, extra = mgr.restore(template)
    assert step == 3 and extra["step"] == 3 and extra["note"] == "x"
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], params["w"])
    assert torch.equal(got["layers"][0]["s"], torch.ones(3))


# ------------------------------------------------------------- the card
@pytest.mark.cuda
def test_cuda_service_threads_launch_on_the_default_stream(ds):
    """The scheduler's query threads and its dispatch lane launch K1 and
    K3 on their current stream, the default stream where their inputs
    are made; a packed run on the card equals serial collect() there."""
    import torch

    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    seen = []
    real = build.stream_ptr

    def spy(device):
        seen.append((threading.current_thread().name, real(device)))
        return real(device)

    build.stream_ptr = spy
    try:
        def run(packed):
            sess = tapi.Session(policy=tapi.ExecutionPolicy(
                method="csv-sim", n_clusters=4, min_sample=8))
            t = sess.table(embeddings=ds.embeddings, name="reviews")
            qs = [t.filter(f"q{i}", _q("port", ds, k, seed=7 + i))
                  for i, k in enumerate(("RV-Q1", "RV-Q2", "RV-Q3"))]
            try:
                if packed:
                    with sess.scheduler.holding():
                        tickets = [sess.submit(q) for q in qs]
                    return sess.gather(*tickets)
                return [q.collect() for q in qs]
            finally:
                sess.close()
        packed, serial = run(True), run(False)
    finally:
        build.stream_ptr = real
    for a, b in zip(packed, serial):
        np.testing.assert_array_equal(a.mask, b.mask)
        assert a.n_llm_calls == b.n_llm_calls
    default = torch.cuda.default_stream(dev).cuda_stream
    threads = {name for name, _ in seen}
    assert any(name.startswith("csv-service-") for name in threads)
    assert all(ptr == default for _, ptr in seen)
