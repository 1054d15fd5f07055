"""The port's stream layer against the JAX reference, on the CPU.

Every case of tests/test_stream.py runs on ``repro.stream`` and on
``repro_torch.stream`` (``device="cpu"``, the reference's k-means++
injected through ``init_centroids``) over the same seeded numpy inputs,
and the two must agree exactly: per-tick summaries, notification events
``(query, tick, row, key, text)``, ``StreamStats``, dead-letter JSONL,
sink files and the checkpoint sidecar's meta.  Beyond those cases: runs
with and without the scheduler, a table that starts empty (as ``watch
--engine`` builds it) with and without an empty first tick, a
``FilterService`` tenant watcher, and checkpoints written by one package
and restored by the other.

The reference's steady-state assertion in
``test_per_tick_cost_sublinear_vs_full_refilter`` does not hold on the
reference itself (tick 10 pays 61 calls); here both packages must give
the same per-tick list, ``[60, 60, 60, 60, 60, 60, 60, 60, 59, 61]``.
"""
import dataclasses
import json
import signal
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import api as japi
from repro import obs as jobs
from repro import service as jservice
from repro import stream as jstream
from repro.core import clustering as jc
from repro.core.oracle import SyntheticOracle as JSyntheticOracle
from repro.data import make_dataset
from repro.service import lifecycle as jlifecycle
from repro_torch import api as tapi
from repro_torch import obs as tobs
from repro_torch import service as tservice
from repro_torch import stream as tstream
from repro_torch.core.oracle import SyntheticOracle
from repro_torch.service import lifecycle as tlifecycle

N = 600
SIDES = {
    "ref": SimpleNamespace(api=japi, obs=jobs, service=jservice,
                           stream=jstream, Oracle=JSyntheticOracle,
                           lifecycle=jlifecycle),
    "port": SimpleNamespace(api=tapi, obs=tobs, service=tservice,
                            stream=tstream, Oracle=SyntheticOracle,
                            lifecycle=tlifecycle),
}
PAIRS = [("ref", "ref"), ("port", "port"), ("ref", "port"), ("port", "ref")]
_plusplus = jax.jit(jc._plusplus_init, static_argnums=2)


def jax_seeder(seed, x, k):
    return np.asarray(_plusplus(jax.random.key(seed), jnp.asarray(x), k))


@pytest.fixture(scope="module")
def ds():
    return make_dataset("imdb_review", n=N, seed=0)


def _pol(side, **kw):
    return SIDES[side].api.ExecutionPolicy(**{"n_clusters": 4, "xi": 0.005,
                                              **kw})


def _session(side, policy=None):
    policy = policy or _pol(side)
    if side == "ref":
        return japi.Session(policy=policy)
    return tapi.Session(policy=policy, init_centroids=jax_seeder,
                        device="cpu")


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.integer, np.bool_, np.floating)):
        return x.item()
    return x


def _both(fn):
    """``fn(side)`` on both packages; the plain results must be equal.
    Returns the port's."""
    out = {side: fn(side) for side in SIDES}
    assert _plain(out["port"]) == _plain(out["ref"])
    return out["port"]


def _blobs(n_per=150, k=4, seed=0):
    """k well-separated clusters (tests/test_stream.py's fixture)."""
    rng = np.random.default_rng(seed)
    centers = np.eye(k, k, dtype=np.float32) * 10.0
    emb = np.concatenate([
        centers[i] + rng.normal(0, 0.5, (n_per, k)).astype(np.float32)
        for i in range(k)])
    labels = np.concatenate([np.full(n_per, bool(i % 2 == 0))
                             for i in range(k)])
    return centers, emb, labels


def _watcher(side, ds, state_dir, n_queries=2, arrive=60, quota=60,
             checkpoint_every=None, use_scheduler=True, service=False,
             source=None, empty_table=False):
    """Session + watcher over one deterministic synthetic stream, with
    CallbackSinks collecting events per query (the reference test's
    ``_watcher``, on either package)."""
    S = SIDES[side]
    sess = _session(side)
    keys = ["RV-Q1", "RV-Q2", "RV-Q3"]
    for i in range(n_queries):
        sess.register_oracle(f"p{i}", S.Oracle(
            ds.labels[keys[i % 3]], flip_prob=0.0, seed=7 + i,
            token_lens=ds.token_lens))
    if empty_table:
        sess.table(texts=[], embeddings=np.zeros(
            (0, ds.embeddings.shape[1]), np.float32), name="feed")
    store = S.service.SessionStore(state_dir) if state_dir is not None \
        else None
    kw = {}
    if service:
        svc = S.service.FilterService(sess)
        svc.register_tenant("t0", sess.policy)
        kw = dict(service=svc, tenant="t0")
    w = S.stream.StreamWatcher(sess, table_name="feed", store=store,
                               checkpoint_every=checkpoint_every,
                               use_scheduler=use_scheduler, **kw)
    w.add_source(source(S.stream) if source is not None else
                 S.stream.SyntheticSource("s0", texts=list(ds.texts),
                                          embeddings=ds.embeddings,
                                          arrive_per_tick=arrive, seed=3),
                 S.stream.RateBudget(rows_per_tick=quota))
    events = {}
    for i in range(n_queries):
        lst = events.setdefault(f"p{i}", [])
        w.register(f"p{i}", sink=S.stream.CallbackSink(
            (lambda L: lambda ev: L.append(ev))(lst)))
    return sess, w, events


def _events(events):
    return {q: [(e["query"], e["tick"], e["row"], e["key"], e["text"])
                for e in evs] for q, evs in events.items()}


def _sidecar_meta(state_dir, tag="watch"):
    return json.loads((state_dir / f"{tag}-stream" / "MANIFEST.json")
                      .read_text())["extra"]


# ------------------------------------------- 1. coalesced micro-batches
def test_coalesced_appends_bit_identical_to_per_append():
    centers, emb, labels = _blobs()
    rng = np.random.default_rng(9)
    chunks = [centers[i % 2] + rng.normal(0, 0.5, (15, 4)).astype(np.float32)
              for i in range(4)]
    post_labels = np.concatenate([labels, np.full(60, True)])

    def run(side):
        pol = _pol(side)

        def build():
            s = _session(side, pol)
            t = s.table(embeddings=emb, name="blobs")
            s.register_oracle("P", SIDES[side].Oracle(
                post_labels, flip_prob=0.0, seed=7))
            return s, t

        s1, t1 = build()
        t1.filter("P").collect()
        for c in chunks:
            t1.append(embeddings=c)
        r1 = t1.filter("P").collect()
        s2, t2 = build()
        t2.filter("P").collect()
        v0 = t2.version
        with t2.coalescing_appends():
            for c in chunks:
                t2.append(embeddings=c)
            assert len(t2) == len(emb)
        assert t2.version == v0 + 1 and t1.version == v0 + 4
        r2 = t2.filter("P").collect()
        assert (r1.mask == r2.mask).all()
        assert (r1.n_llm_calls, r1.pilot_calls, r1.n_replayed) == \
            (r2.n_llm_calls, r2.pilot_calls, r2.n_replayed)
        a1 = s1._assign_cache[("blobs", 4, pol.seed)]
        a2 = s2._assign_cache[("blobs", 4, pol.seed)]
        assert (a1 == a2).all()
        d1, d2 = t1._dirty[(4, pol.seed)], t2._dirty[(4, pol.seed)]
        assert ((d1 > 0) == (d2 > 0)).all() and (d2 > 0).sum() == 2
        return (r2.mask, r2.n_llm_calls, r2.pilot_calls, r2.n_replayed, a2,
                d2 > 0, r1.mask, r1.n_llm_calls)

    _both(run)


def test_coalescing_nested_and_empty_blocks():
    _, emb, _ = _blobs(n_per=40)

    def run(side):
        t = _session(side).table(embeddings=emb, name="b")
        v0 = t.version
        with t.coalescing_appends():
            pass
        assert t.version == v0
        with t.coalescing_appends():
            t.append(embeddings=emb[:3])
            with t.coalescing_appends():
                t.append(embeddings=emb[3:5])
            assert len(t) == len(emb)
        assert t.version == v0 + 1 and len(t) == len(emb) + 5
        return t.version, len(t), t.embeddings

    _both(run)


# ------------------------------------------------- 2. idle scheduler
def test_idle_scheduler_performs_no_dispatch_work(ds):
    def run(side):
        sess = _session(side)
        sch = sess.scheduler
        assert sch.idle.wait(2.0)
        for _ in range(5):
            with sch._cv:
                sch._cv.notify_all()
        time.sleep(0.1)
        assert sch.stats.n_dispatch_ticks == 0 and sch.idle.is_set()
        t = sess.table(embeddings=ds.embeddings, name="r")
        r = sess.submit(t.filter(SIDES[side].Oracle(
            ds.labels["RV-Q1"], flip_prob=0.0, seed=7), name="A")).result()
        assert r.mask.sum() > 0
        busy = sch.stats.n_dispatch_ticks
        assert busy > 0
        assert sch.idle.wait(5.0)
        time.sleep(0.1)
        assert sch.stats.n_dispatch_ticks == busy
        assert sch.stats.metrics_view()["service.dispatch_ticks"] == busy
        sess.close()
        return r.mask, r.n_llm_calls

    _both(run)


# ------------------------------------------------- 3. quota deferral
def test_quota_defers_rows_without_dropping(ds):
    def run(side):
        sess, w, events = _watcher(side, ds, None, n_queries=1, arrive=90,
                                   quota=40)
        summaries = w.run()
        assert max(s["backlog"] for s in summaries) > 0
        assert all(s["rows"] <= 40 for s in summaries)
        assert w.stats.n_rows_ingested == N and w.drained
        assert len(w.handle) == N
        assert w._sources[0][0].state()["ingested"] == N
        assert w.stats.n_ticks > N / 90
        sess.close()
        return summaries, _events(events), dataclasses.asdict(w.stats)

    _both(run)


# ------------------------------------------------- 4. delta + sinks
def test_delta_tracker_newly_matching_and_content_dedup():
    def run(side):
        d = SIDES[side].stream.DeltaTracker()
        keys = [f"k{i}" for i in range(6)]
        out = [d.delta(np.array([1, 0, 1, 0, 0, 0], bool), keys)]
        d.ack(np.array([1, 0, 1, 0, 0, 0], bool))
        out.append(d.delta(np.array([1, 0, 0, 1, 0, 0], bool), keys))
        d.ack(np.array([1, 0, 0, 1, 0, 0], bool))
        keys[4] = keys[0]
        out.append(d.delta(np.array([1, 0, 1, 1, 1, 0], bool), keys))
        with pytest.raises(ValueError):
            d.delta(np.zeros(3, bool), keys[:3])
        assert out == [([0, 2], 0), ([3], 0), ([], 2)]
        return out, d.state(), d.acked

    _both(run)


def test_row_key_hashes_the_same_bytes(ds):
    def run(side):
        rk = SIDES[side].stream.row_key
        return ([rk(t, None) for t in ds.texts[:20]]
                + [rk(None, e) for e in ds.embeddings[:20]]
                + [rk(None, ds.embeddings[0].astype(np.float64))])

    keys = _both(run)
    assert len(set(keys)) == 40 and keys[-1] == keys[20]


def test_sink_retry_then_dead_letter(tmp_path):
    def run(side):
        calls = {"n": 0}
        delivered = []

        def flaky(ev):
            if ev["row"] == 13:
                raise IOError("wedged")
            calls["n"] += 1
            if ev["row"] == 7 and calls["n"] == 1:
                raise IOError("transient")
            delivered.append(ev)

        st = SIDES[side].stream
        dead = tmp_path / f"{side}-dead.jsonl"
        runner = st.SinkRunner(st.CallbackSink(flaky), retries=2,
                               dead_letter_path=dead)
        ok = [runner.deliver({"query": "q", "row": r}) for r in (7, 13, 21)]
        s = runner.stats
        assert ok == [True, False, True]
        assert s.n_delivered == 2 and s.n_dead_lettered == 1
        assert s.n_retries >= 1
        assert [e["row"] for e in delivered] == [7, 21]
        assert "OSError" in runner.dead_letters[0]["error"]
        assert dead.read_text().count("\n") == 1
        return (dataclasses.asdict(s), s.metrics_view(), runner.dead_letters,
                dead.read_text(), delivered)

    _both(run)


def test_dead_lettered_row_not_renotified(ds, tmp_path):
    def run(side):
        st = SIDES[side].stream
        sess, w, _ = _watcher(side, ds, tmp_path / side, n_queries=1,
                              arrive=100, quota=100)
        sq = w.queries["p0"]
        sq.runner = st.SinkRunner(st.CallbackSink(
            lambda ev: (_ for _ in ()).throw(IOError("down"))), retries=0,
            dead_letter_path=tmp_path / f"{side}.jsonl")
        summaries = w.run(n_ticks=3)
        assert sq.runner.stats.n_dead_lettered > 0
        assert sq.runner.stats.n_delivered == 0
        rows = [d["row"] for d in sq.runner.dead_letters]
        assert len(rows) == len(set(rows))
        sess.close()
        return (summaries, sq.runner.dead_letters,
                (tmp_path / f"{side}.jsonl").read_text(),
                dataclasses.asdict(sq.runner.stats))

    _both(run)


# ------------------------------------------------- 5. graceful shutdown
def test_graceful_shutdown_runs_cleanups_once():
    def run(side):
        ran = []
        gs = SIDES[side].lifecycle.GracefulShutdown(
            exit_on_signal=False).install()
        gs.register("a", lambda: ran.append("a"))
        gs.register("boom", lambda: (_ for _ in ()).throw(RuntimeError("x")))
        gs.register("b", lambda: ran.append("b"))
        assert not gs.requested
        gs.trigger(signal.SIGTERM)
        assert gs.requested and gs.signum == signal.SIGTERM
        gs.trigger(signal.SIGTERM)
        gs.close()
        return ran

    assert _both(run) == ["a", "b"]


def test_graceful_shutdown_exit_mode_raises_systemexit():
    def run(side):
        ran = []
        gs = SIDES[side].lifecycle.GracefulShutdown(exit_on_signal=True)
        gs.register("ckpt", lambda: ran.append(1))
        with pytest.raises(SystemExit) as exc:
            gs._handler(signal.SIGINT, None)
        return exc.value.code, ran

    assert _both(run) == (128 + signal.SIGINT, [1])


def test_graceful_shutdown_close_restores_signal_handlers():
    """In-process entry points install handlers and must put the previous
    ones back on ``close()``."""
    def run(side):
        before = [signal.getsignal(s) for s in (signal.SIGINT,
                                                signal.SIGTERM)]
        gs = SIDES[side].lifecycle.GracefulShutdown(
            exit_on_signal=True).install()
        installed = signal.getsignal(signal.SIGTERM) is not before[1]
        gs.close()
        after = [signal.getsignal(s) for s in (signal.SIGINT,
                                               signal.SIGTERM)]
        return installed, after == before

    assert _both(run) == (True, True)


def test_watcher_shutdown_checkpoints_and_flushes_sinks(ds, tmp_path):
    def run(side):
        S = SIDES[side]
        sess, w, _ = _watcher(side, ds, tmp_path / side, n_queries=1,
                              arrive=80, quota=80)
        sink_path = tmp_path / f"{side}-out.jsonl"
        sq = w.queries["p0"]
        sq.runner = S.stream.SinkRunner(S.stream.JsonlSink(sink_path),
                                        retries=0)
        w.run(n_ticks=2)
        gs = S.lifecycle.GracefulShutdown(exit_on_signal=False).install()
        gs.register("watch-shutdown", w.shutdown)
        gs.trigger(signal.SIGINT)
        gs.close()
        assert w.has_checkpoint()
        text = sink_path.read_text()
        assert len(text.strip().splitlines()) == \
            sq.runner.stats.n_delivered > 0
        sess.close()
        return text, _sidecar_meta(tmp_path / side)

    _both(run)


# ---------------------------------------- 6. kill/restart mid-stream
@pytest.fixture(scope="module")
def control(ds):
    """The unkilled run, on each package."""
    out = {}
    for side in SIDES:
        sess, w, ev = _watcher(side, ds, None)
        ticks = w.run()
        sess.close()
        out[side] = (ticks, ev, dataclasses.asdict(w.stats))
    assert _plain(out["port"][:2]) == _plain(out["ref"][:2])
    assert _events(out["port"][1]) == _events(out["ref"][1])
    return out["port"]


@pytest.mark.parametrize("writer,reader", PAIRS,
                         ids=[f"{w}-to-{r}" for w, r in PAIRS])
def test_midstream_reload_matches_unkilled_control(ds, tmp_path, control,
                                                   writer, reader):
    """Killed after tick k by one package, restored by ``reader``: the
    tail notifies exactly the control's rows at the control's calls."""
    ticks_c, ev_c, _ = control
    k = 4
    state = tmp_path / "run"
    sess_a, w_a, ev_a = _watcher(writer, ds, state)
    for _ in range(k):
        w_a.tick()
    w_a.shutdown()
    sess_a.close()

    sess_b, w_b, ev_b = _watcher(reader, ds, state)
    assert w_b.has_checkpoint()
    report = w_b.restore()
    assert report.tables == ["feed"] and not report.skipped
    assert sess_b.stats.n_calls == 0
    assert w_b.stats.n_ticks == k
    ticks_b = w_b.run()
    sess_b.close()
    for q in ev_c:
        ctl_tail = [(e["tick"], e["row"]) for e in ev_c[q] if e["tick"] > k]
        assert [(e["tick"], e["row"]) for e in ev_b[q]] == ctl_tail
        all_keys = [e["key"] for e in ev_a[q]] + [e["key"] for e in ev_b[q]]
        assert len(all_keys) == len(set(all_keys))
        assert sorted(all_keys) == sorted(e["key"] for e in ev_c[q])
    assert ticks_b == ticks_c[k:]


def test_checkpoint_files_agree_across_packages(ds, tmp_path):
    """The same run checkpointed every 2 ticks by each package: equal
    sidecar meta and acked masks, and each package's store loads into the
    other's session."""
    def run(side):
        sess, w, ev = _watcher(side, ds, tmp_path / side,
                               checkpoint_every=2)
        w.run(n_ticks=5)
        w.shutdown()
        sess.close()
        by_key, meta = SIDES[side].stream.watcher.load_pytree(
            tmp_path / side / "watch-stream")
        return meta, by_key, _events(ev)

    _both(run)
    # each package's loader reads the other's sidecar to the same arrays
    for a, b in (("ref", "port"), ("port", "ref")):
        got, meta = SIDES[b].stream.watcher.load_pytree(
            tmp_path / a / "watch-stream")
        want, _ = SIDES[a].stream.watcher.load_pytree(
            tmp_path / a / "watch-stream")
        assert meta == _sidecar_meta(tmp_path / a)
        assert _plain(got) == _plain(want)


# ------------------------------- 7. sublinear cost + unified metrics
def test_per_tick_cost_sublinear_vs_full_refilter(ds):
    def run(side):
        sess, w, _ = _watcher(side, ds, None, n_queries=1)
        inc = [s["oracle_calls"] for s in w.run()]
        sess.close()
        full = []
        for t in range(1, len(inc) + 1):
            n_t = min(N, 60 * t)
            s = _session(side)
            s.register_oracle("p0", SIDES[side].Oracle(
                ds.labels["RV-Q1"], flip_prob=0.0, seed=7,
                token_lens=ds.token_lens))
            h = s.table(texts=list(ds.texts[:n_t]),
                        embeddings=ds.embeddings[:n_t], name="feed")
            full.append(h.filter("p0").collect().n_llm_calls)
        return inc, full

    inc, full = _both(run)
    # what the reference does: tick 10 pays 61 calls, so its steady-state
    # assertion (every tick after the first <= 60) fails on both packages
    assert inc == [60, 60, 60, 60, 60, 60, 60, 60, 59, 61]
    assert sum(inc) < 0.5 * sum(full)
    assert full[-1] > 3 * inc[-1]


def test_stream_metrics_under_unified_names(ds, tmp_path):
    def run(side):
        O = SIDES[side].obs
        tr = O.Tracer(metrics=O.MetricsRegistry())
        with O.use_tracer(tr):
            sess, w, ev = _watcher(side, ds, tmp_path / side, n_queries=1,
                                   arrive=80, quota=80)
            w.run(n_ticks=3)
            sess.close()
        snap = tr.metrics.snapshot()
        assert snap["stream.ticks"] == 3
        assert snap["stream.rows_ingested"] == w.stats.n_rows_ingested
        assert snap["session.append_rows"] == w.stats.n_rows_ingested - 80
        assert snap["sink.delivered"] == len(ev["p0"])
        ticks = [s for s in tr.spans() if s.kind == "stream_tick"]
        assert len(ticks) == 3
        reg = O.MetricsRegistry()
        reg.sync_from(w)
        out = reg.snapshot()
        assert out["stream.notifications"] == w.stats.n_notifications
        assert out["sink.delivered"] == len(ev["p0"])
        assert out["sink.dead_lettered"] == 0
        names = ("stream.", "sink.", "session.append_rows", "memo.")
        return ({k: v for k, v in snap.items() if k.startswith(names)},
                [s.attrs for s in ticks], out, w.metrics_view(),
                w.status_view())

    _both(run)


def test_memo_dirty_clusters_metric():
    centers, emb, labels = _blobs()
    post = np.concatenate([labels, np.full(10, True)])

    def run(side):
        O = SIDES[side].obs
        tr = O.Tracer(metrics=O.MetricsRegistry())
        with O.use_tracer(tr):
            s = _session(side)
            t = s.table(embeddings=emb, name="b")
            s.register_oracle("P", SIDES[side].Oracle(post, flip_prob=0.0,
                                                      seed=7))
            t.filter("P").collect()
            rng = np.random.default_rng(3)
            t.append(embeddings=(centers[0] + rng.normal(0, 0.5, (10, 4))
                                 ).astype(np.float32))
            r = t.filter("P").collect()
        assert tr.metrics.snapshot()["memo.dirty_clusters"] == 1
        assert r.n_replayed > 0
        return r.mask, r.n_llm_calls, r.n_replayed

    _both(run)


# ------------------------------------- beyond the reference test's cases
@pytest.mark.parametrize("use_scheduler", [True, False])
@pytest.mark.parametrize("n_queries", [1, 3])
def test_full_stream_equal_with_and_without_scheduler(ds, use_scheduler,
                                                      n_queries):
    def run(side):
        sess, w, ev = _watcher(side, ds, None, n_queries=n_queries,
                               arrive=(20, 90), quota=50,
                               use_scheduler=use_scheduler)
        ticks = w.run()
        sess.close()
        return ticks, _events(ev), dataclasses.asdict(w.stats)

    ticks, events, stats = _both(run)
    assert stats["n_rows_ingested"] == N
    # the scheduler changes how oracle batches merge, never a decision
    if use_scheduler:
        sess, w, ev = _watcher("port", ds, None, n_queries=n_queries,
                               arrive=(20, 90), quota=50,
                               use_scheduler=False)
        assert w.run() == ticks and _events(ev) == events
        sess.close()


@pytest.mark.parametrize("empty_first_tick", [False, True])
@pytest.mark.parametrize("empty_table", [False, True])
def test_first_tick_creates_or_fills_the_table(ds, empty_table,
                                               empty_first_tick):
    """A table that starts empty (``watch --engine``) or is created by the
    first rows, and a first tick with no arrivals: the same ticks and
    events on both packages (an empty tick over an empty table evaluates
    0 rows at 0 calls)."""
    def source(st):
        records = [st.StreamRow(text=t, embedding=e)
                   for t, e in zip(ds.texts, ds.embeddings)]
        return st.StreamSource(
            "s0", records,
            lambda t: 0 if (empty_first_tick and t == 1) else 60)

    def run(side):
        sess, w, ev = _watcher(side, ds, None, source=source,
                               empty_table=empty_table)
        ticks = w.run(n_ticks=4)
        sess.close()
        return ticks, _events(ev), w.status_view()

    ticks, _, _ = _both(run)
    assert ticks[0]["rows"] == (0 if empty_first_tick else 60)
    assert ticks[0]["oracle_calls"] == (0 if empty_first_tick else 120)


def test_filter_service_tenant_watcher(ds, tmp_path):
    def run(side):
        sess, w, ev = _watcher(side, ds, tmp_path / side, service=True,
                               checkpoint_every=3)
        ticks = w.run()
        acct = w.service.tenant("t0")
        w.shutdown()
        w.service.close()
        sess.close()
        return (ticks, _events(ev), acct.spent, acct.n_admitted,
                _sidecar_meta(tmp_path / side))

    ticks, _, spent, admitted, _ = _both(run)
    assert spent == sum(t["oracle_calls"] for t in ticks)
    assert admitted == 2 * len(ticks)


BENCH_QUERIES = [("q0_pos", "RV-Q1", 7), ("q1_act", "RV-Q3", 8)]


def test_sim_stream_vote_flips_match_reference():
    """benchmarks/bench_stream_ingest.py's two standing queries under
    csv-sim (the policy of chip_smoke.py phase 10), 4,000 x 256 rows
    arriving 400 a tick: the same ticks, events, decided-mask sizes and
    final masks on both packages.

    Here the incremental re-votes lose RV-Q3's rare matches (5% of the
    rows): each tick re-votes every cluster, and on some ticks the votes
    decide all unsampled rows of the matching topic negative, so the
    decided mask drops to a few sampled rows.  It ends at 16 of the 256
    true matches, and 207 of the 223 notified rows are vote flips, far
    over the bench's bound max(2, 5% of notified).  The reference does
    this as well as the port."""
    ds = make_dataset("imdb_review", n=4000, dim=256, seed=0)

    def run(side):
        S = SIDES[side]
        sess = _session(side, _pol(side, method="csv-sim"))
        for name, key, seed in BENCH_QUERIES:
            sess.register_oracle(name, S.Oracle(
                ds.labels[key], flip_prob=0.0, seed=seed,
                token_lens=ds.token_lens))
        w = S.stream.StreamWatcher(sess, table_name="feed")
        w.add_source(S.stream.SyntheticSource(
            "feed0", texts=list(ds.texts), embeddings=ds.embeddings,
            arrive_per_tick=400, seed=3),
            S.stream.RateBudget(rows_per_tick=400))
        events = {name: [] for name, _, _ in BENCH_QUERIES}
        for name, evs in events.items():
            w.register(name, sink=S.stream.CallbackSink(evs.append))
        ticks, decided = [], []
        while not w.drained:
            ticks.append(w.tick())
            decided.append([int(w.queries[name].delta.acked.sum())
                            for name, _, _ in BENCH_QUERIES])
        final = {name: sess["feed"].filter(name).collect().mask
                 for name, _, _ in BENCH_QUERIES}
        sess.close()
        return ticks, _events(events), decided, final

    ticks, events, decided, final = _both(run)
    assert [t["oracle_calls"] for t in ticks] == \
        [772, 545, 464, 591, 516, 532, 501, 463, 469, 424]
    flips = {}
    for name, key, _ in BENCH_QUERIES:
        rows = [e[2] for e in events[name]]
        assert len(rows) == len(set(rows))
        flips[name] = (len(rows), int(final[name].sum()),
                       int(ds.labels[key].sum()),
                       len(set(rows) - set(np.nonzero(final[name])[0])))
    # (notified, final mask, true matches, flips)
    assert flips == {"q0_pos": (2065, 2002, 2009, 63),
                     "q1_act": (223, 16, 256, 207)}
    assert min(d[1] for d in decided) < 0.2 * max(d[1] for d in decided)


def test_replay_file_source_and_stdout_sink(ds, tmp_path, capsys):
    path = tmp_path / "feed.jsonl"
    with path.open("w") as f:
        for t, e in zip(ds.texts[:100], ds.embeddings[:100]):
            f.write(json.dumps({"text": t, "embedding": e.tolist()}) + "\n")
            f.write("\n")

    def run(side):
        st = SIDES[side].stream
        src = st.ReplayFileSource(path, arrive_per_tick=30)
        sess = _session(side)
        sess.register_oracle("p0", SIDES[side].Oracle(
            ds.labels["RV-Q1"][:100], flip_prob=0.0, seed=7))
        w = st.StreamWatcher(sess, table_name="feed")
        w.add_source(src)
        w.register("p0", sink=st.StdoutSink(prefix="hit"))
        capsys.readouterr()
        ticks = w.run()
        out = capsys.readouterr().out
        sess.close()
        return src.name, ticks, out, repr(src)

    name, _, out, _ = _both(run)
    assert name == "feed" and out.startswith("[hit] {")
