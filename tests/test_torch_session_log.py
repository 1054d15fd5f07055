"""The port's append-only session log against the JAX reference.

The cases of tests/test_session_log.py on ``repro_torch.service.log``
(framed-record round trip, torn-final-record truncate and recover,
corrupt-frame suffix drop, concurrent-writer rejection, stale-lock steal,
compaction mid-stream equivalence, restart cost bounded by the tail,
generation cleanup, save-time drops surfaced), each also held against the
reference on the same inputs; and the log format across packages: frames
the port writes read back with the reference's reader and the other way
round, and a session the reference logged restored by the port at zero
oracle calls with the reference's masks.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import api as japi
from repro.core import clustering as jc
from repro.core.oracle import SyntheticOracle as JSyntheticOracle
from repro.data import make_dataset
from repro.service import SessionStore as JSessionStore
from repro.service import log as jlog
from repro_torch import api as tapi
from repro_torch.core.oracle import SyntheticOracle
from repro_torch.service import SessionStore
from repro_torch.service import log as tlog
from repro_torch.service.log import (ConcurrentWriterError, LOG_MAGIC,
                                     SessionLogStore, pack_record,
                                     read_records)

N = 900
_plusplus = jax.jit(jc._plusplus_init, static_argnums=2)


def jax_seeder(seed, x, k):
    """The reference's k-means++ for ``jax.random.key(seed)``."""
    return np.asarray(_plusplus(jax.random.key(seed), jnp.asarray(x), k))


SIDES = {"ref": (japi, JSyntheticOracle, jlog, JSessionStore),
         "port": (tapi, SyntheticOracle, tlog, SessionStore)}


@pytest.fixture(scope="module")
def ds():
    return make_dataset("imdb_review", n=N, seed=0)


def _pol(side):
    return SIDES[side][0].ExecutionPolicy(n_clusters=24, xi=0.01, seed=0)


def _session(side):
    if side == "ref":
        return japi.Session(policy=_pol(side))
    return tapi.Session(policy=_pol(side), init_centroids=jax_seeder,
                        device="cpu")


def _build(ds, side="port", extra=()):
    sess = _session(side)
    t = sess.table(embeddings=ds.embeddings, name="reviews")
    Oracle = SIDES[side][1]
    sess.register_oracle("A", Oracle(ds.labels["RV-Q1"], flip_prob=0.02,
                                     seed=7, token_lens=ds.token_lens))
    for name, labels in extra:
        sess.register_oracle(name, Oracle(labels, flip_prob=0.0, seed=11))
    return sess, t


def _both(fn):
    """fn(side) for both packages; asserts equal returned values."""
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
    return x


# ----------------------------------------------------------- frame codec
PAYLOADS = [{"t": "x", "i": 7, "arr": np.arange(6).reshape(2, 3)},
            {"t": "y", "s": "text", "f": 0.25, "none": None},
            {"t": "decision", "mask": np.array([True, False, True]),
             "fp": [1, "a", 0.5], "emb": np.ones((2, 3), np.float32)}]


def test_frame_roundtrip(tmp_path):
    p = tmp_path / "wal_000000.log"
    p.write_bytes(LOG_MAGIC + b"".join(pack_record(r) for r in PAYLOADS))
    records, ends, valid_end, size = read_records(p)
    assert valid_end == size == ends[-1]
    assert records[0]["i"] == 7
    assert (records[0]["arr"] == np.arange(6).reshape(2, 3)).all()
    assert records[1] == PAYLOADS[1]


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_frames_cross_packages(tmp_path, writer, reader):
    """Frames are byte-identical between packages, and each package's
    reader reads the other's file."""
    w, r = SIDES[writer][2], SIDES[reader][2]
    assert w.LOG_MAGIC == r.LOG_MAGIC
    for payload in PAYLOADS:
        assert w.pack_record(payload) == r.pack_record(payload)
    p = tmp_path / "wal_000000.log"
    p.write_bytes(w.LOG_MAGIC + b"".join(w.pack_record(x) for x in PAYLOADS))
    got, ends, valid_end, size = r.read_records(p)
    want = w.read_records(p)
    assert (ends, valid_end, size) == tuple(want[1:])
    assert _plain(got) == _plain(want[0]) == _plain(PAYLOADS)


def test_torn_final_record_truncate_and_recover(ds, tmp_path):
    def run(side):
        d = tmp_path / side
        sess, t = _build(ds, side)
        log = SIDES[side][2].SessionLogStore(d)
        log.attach(sess)
        r1 = t.filter("A").collect()
        log.abandon()
        sess.close()

        gen = sorted(d.glob("wal_*.log"))[-1]
        intact = gen.stat().st_size
        with open(gen, "ab") as fh:        # crash mid-append: half a frame
            fh.write(pack_record({"t": "emb", "keys": [], "rows":
                                  np.zeros((0, 4), np.float32)})[:9])
        sess2, t2 = _build(ds, side)
        log2 = SIDES[side][2].SessionLogStore(d)
        rep = log2.restore(sess2)
        assert rep.torn_bytes == gen.stat().st_size - intact > 0
        log2.attach(sess2)                 # attach truncates the torn tail
        assert gen.stat().st_size == intact
        r2 = t2.filter("A").collect()
        assert (r2.mask == r1.mask).all() and r2.n_llm_calls == 0
        records, _, valid_end, size = read_records(gen)
        assert valid_end == size
        log2.close()
        sess2.close()
        return r1.mask, r1.n_llm_calls, rep.torn_bytes, rep.n_tail_records
    _both(run)


def test_corrupt_frame_drops_suffix(tmp_path):
    p = tmp_path / "wal_000000.log"
    recs = [{"t": "x", "i": i} for i in range(5)]
    frames = [pack_record(r) for r in recs]
    blob = bytearray(LOG_MAGIC + b"".join(frames))
    off = len(LOG_MAGIC) + len(frames[0]) + len(frames[1]) + 10
    blob[off] ^= 0xFF
    p.write_bytes(bytes(blob))
    records, _, valid_end, size = read_records(p)
    assert [r["i"] for r in records] == [0, 1]
    assert valid_end < size
    assert jlog.read_records(p)[2] == valid_end


# ------------------------------------------------------------------ lock
def test_concurrent_writer_rejected(ds, tmp_path):
    sess, t = _build(ds)
    log = SessionLogStore(tmp_path)
    log.attach(sess)
    with pytest.raises(ConcurrentWriterError, match="live writer"):
        SessionLogStore(tmp_path).attach(sess)
    # the reference's writer respects the port's lock file too
    with pytest.raises(jlog.ConcurrentWriterError, match="live writer"):
        jlog.SessionLogStore(tmp_path).attach(_build(ds, "ref")[0])
    log.close()
    sess.close()


def test_stale_lock_of_dead_pid_is_stolen(ds, tmp_path):
    (tmp_path / "wal.lock").write_text("999999999")
    sess, t = _build(ds)
    log = SessionLogStore(tmp_path)
    log.attach(sess)
    assert (tmp_path / "wal.lock").read_text() == str(os.getpid())
    log.close()
    assert not (tmp_path / "wal.lock").exists()
    sess.close()


# ------------------------------------------------------------ compaction
def test_compaction_mid_stream_equivalent_to_uncompacted(ds, tmp_path):
    """Same event stream, with and without a compaction in the middle:
    both restores rebuild identical behaviour (masks + zero calls), in
    both packages alike."""
    big = make_dataset("imdb_review", n=N + 100, seed=0)
    extra = [("C", big.labels["RV-Q1"]), ("D", big.labels["RV-Q3"])]

    def run(side, dirname, compact_mid):
        d = tmp_path / side / dirname
        sess, t = _build(ds, side, extra=extra)
        log = SIDES[side][2].SessionLogStore(d)
        log.attach(sess)
        r1 = t.filter("A").collect()
        t.append(embeddings=big.embeddings[N:])      # mutation record
        r2 = t.filter("C").collect()
        if compact_mid:
            log.compact(sess)
        r3 = t.filter("D").collect()                 # tail after snapshot
        log.abandon()
        sess.close()

        sess2, t2 = _build(ds, side, extra=extra)    # base table only
        log2 = SIDES[side][2].SessionLogStore(d)
        rep = log2.restore(sess2)
        log2.attach(sess2)
        g2C = t2.filter("C").collect()
        g2D = t2.filter("D").collect()
        assert g2C.n_llm_calls == g2D.n_llm_calls == 0
        assert len(t2) == N + 100
        log2.close()
        sess2.close()
        return (r1.mask, r2.mask, r3.mask), (g2C.mask, g2D.mask), rep

    def side_run(side):
        live_c, restored_c, rep_c = run(side, "compacted", True)
        live_u, restored_u, rep_u = run(side, "uncompacted", False)
        for a, b in zip(live_c, live_u):
            assert (a == b).all()          # compaction is invisible live
        for live, back in ((live_c, restored_c), (live_u, restored_u)):
            for a, b in zip(live[1:], back):
                assert (a == b).all()      # ...and across a restart
        assert rep_c.snapshot is not None and rep_c.n_carried_mutations == 1
        assert rep_u.snapshot is None and rep_u.n_tail_records > 0
        return (live_c, rep_c.n_carried_mutations, rep_c.n_tail_records,
                rep_u.n_tail_records)
    _both(side_run)


def test_restart_cost_bounded_by_tail_not_session(ds, tmp_path):
    def run(side):
        d = tmp_path / side
        sess, t = _build(ds, side)
        log = SIDES[side][2].SessionLogStore(d)
        log.attach(sess)
        t.filter("A").collect()
        pre_compact = read_records(sorted(d.glob("wal_*.log"))[-1])[0]
        assert len(pre_compact) > 3        # the session did accumulate
        log.compact(sess)
        log.close(compact=False)
        sess.close()

        sess2, t2 = _build(ds, side)
        log2 = SIDES[side][2].SessionLogStore(d)
        rep = log2.restore(sess2)
        assert rep.snapshot is not None
        assert rep.n_tail_records == 0     # bounded by tail, not history
        log2.attach(sess2)
        r = t2.filter("A").collect()
        assert r.n_llm_calls == 0
        log2.close()
        sess2.close()
        return [x["t"] for x in pre_compact], r.mask
    _both(run)


def test_compaction_deletes_old_generations(ds, tmp_path):
    sess, t = _build(ds)
    log = SessionLogStore(tmp_path)
    log.attach(sess)
    t.filter("A").collect()
    log.compact(sess)
    log.compact(sess)
    gens = sorted(tmp_path.glob("wal_*.log"))
    assert len(gens) == 1 and gens[0].name == "wal_000002.log"
    assert log.tail_summary()["generation"] == 2
    log.close()
    sess.close()


def test_snapshot_restore_surfaces_save_time_drops(ds, tmp_path):
    def run(side):
        d = tmp_path / side
        sess = _session(side)
        t = sess.table(embeddings=ds.embeddings, name="reviews")
        anon = SIDES[side][1](ds.labels["RV-Q1"], flip_prob=0.02, seed=7,
                              token_lens=ds.token_lens)
        t.filter(anon, name="q").collect()  # memoized under an id()
        SIDES[side][3](d).save(sess)
        sess.close()

        sess2 = _session(side)
        sess2.table(embeddings=ds.embeddings, name="reviews")
        rep = SIDES[side][3](d).load(sess2)
        assert rep.dropped
        assert any("unregistered oracle" in x for x in rep.dropped)
        assert "dropped at save" in str(rep)
        sess2.close()
        return str(rep)
    _both(run)


# ------------------------------------------------- a log across packages
def test_port_restores_a_session_the_reference_logged(ds, tmp_path):
    """The reference collects and logs; the port restores from that log
    and replays at zero oracle calls with the reference's mask."""
    sess, t = _build(ds, "ref")
    log = jlog.SessionLogStore(tmp_path)
    log.attach(sess)
    want = t.filter("A").collect()
    log.close()
    sess.close()

    sess2, t2 = _build(ds, "port")
    log2 = SessionLogStore(tmp_path)
    rep = log2.restore(sess2)
    assert rep.n_tail_records > 0 and not rep.skipped
    got = t2.filter("A").collect()
    assert got.n_llm_calls == 0 and got.n_replayed == N
    np.testing.assert_array_equal(got.mask, want.mask)
    sess2.close()
