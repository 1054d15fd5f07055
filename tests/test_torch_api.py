"""The port's declarative entry point (Session -> plan -> collect), session
memo, embedding cache and online audit against the JAX reference.

The same calls go to ``repro.api`` and ``repro_torch.api`` (``device="cpu"``,
the reference's k-means++ injected through ``init_centroids``) on the same
numpy inputs: masks, call counts, ``n_replayed``, ``node_log``, round logs,
the rendered ``explain()``, join pair masks, the baselines, append/update
invalidation and audit reports are equal.  Modelled on tests/test_api.py,
tests/test_session_reuse.py and the audit cases of tests/test_quality_obs.py;
the cases that need the service, the coordinator or the session log wait
for that slice (ROADMAP.md queue 1, step 7).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import ProxyModel as JProxyModel
from repro.core.operators import accuracy_f1 as j_accuracy_f1
from repro.core import clustering as jc
from repro.core.oracle import SyntheticOracle as JSyntheticOracle
from repro.data import make_dataset
from repro_torch import api as tapi
from repro_torch.core import ProxyModel, SemanticTable
from repro_torch.core.operators import accuracy_f1
from repro_torch.core.oracle import SyntheticOracle
from repro_torch.plan import JoinConfig, sem_join

N = 1500
_plusplus = jax.jit(jc._plusplus_init, static_argnums=2)


def jax_seeder(seed, x, k):
    """The reference's k-means++ for ``jax.random.key(seed)``."""
    return np.asarray(_plusplus(jax.random.key(seed), jnp.asarray(x), k))


@pytest.fixture(scope="module")
def ds():
    return make_dataset("imdb_review", n=N, seed=0)


SIDES = {"ref": (japi, JSyntheticOracle, JProxyModel),
         "port": (tapi, SyntheticOracle, ProxyModel)}


def _session(side, **kw):
    if side == "ref":
        return japi.Session(**kw)
    return tapi.Session(device="cpu", init_centroids=jax_seeder, **kw)


def _oracle(side, ds, q="RV-Q1", flip=0.02):
    return SIDES[side][1](ds.labels[q], flip_prob=flip, seed=7,
                          token_lens=ds.token_lens)


def _proxy(side, ds):
    return SIDES[side][2](ds.labels["RV-Q1"], token_lens=ds.token_lens,
                          quality=0.8, center=0.82, concentration=0.15)


def _pol(side, **kw):
    return SIDES[side][0].ExecutionPolicy(**kw)


def _asdict(x):
    """Dataclasses (nested, in lists and dicts) as plain values; arrays as
    lists; wall times dropped."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _asdict(getattr(x, f.name))
                for f in dataclasses.fields(x)
                if f.name not in ("total_time_s", "recluster_time_s")}
    if isinstance(x, dict):
        return {k: _asdict(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_asdict(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


def _query_fields(r):
    """A QueryResult as plain values, without its policy, wall times or
    the raw result (compared field by field through node_log)."""
    d = {k: _asdict(getattr(r, k))
         for k in ("kind", "n_llm_calls", "pilot_calls", "n_proxy_calls",
                   "input_tokens", "output_tokens", "order", "node_log",
                   "round_log", "n_replayed", "node_estimates", "mask",
                   "pair_mask", "audit")}
    return d


def _both(fn):
    """fn(side) for both sides; asserts equal plain values; returns the
    port's."""
    out = {side: fn(side) for side in SIDES}
    assert _asdict(out["port"]) == _asdict(out["ref"])
    return out["port"]


# --------------------------------------------------------------- laziness
def test_building_queries_spends_zero_oracle_calls(ds):
    sess = _session("port")
    t = sess.table(texts=ds.texts, embeddings=ds.embeddings, name="reviews")
    o1, o2 = _oracle("port", ds), _oracle("port", ds, "RV-Q3")
    q = t.filter(o1, name="q1") & ~t.filter(o2, name="q3")
    assert isinstance(q, tapi.FilterQuery)
    jo = SyntheticOracle(np.zeros(N, dtype=bool))
    t.join(sess.table(embeddings=ds.embeddings[:1], name="tiny"), jo)
    assert o1.stats.n_calls == o2.stats.n_calls == jo.stats.n_calls == 0
    assert sess.stats.n_calls == 0
    ex = t.filter(o1, name="q").explain()  # a bare Pred: closed form
    assert o1.stats.n_calls == 0 and ex.pilot_calls == 0
    assert "est_oracle_calls" in str(ex)


# ------------------------------------------- explain and collect: filters
def _query(side, t, ds, shape):
    o = lambda q, name: t.filter(name, _oracle(side, ds, q))  # noqa: E731
    if shape == "single":
        return o("RV-Q1", "q1")
    if shape == "and3":
        return o("RV-Q1", "q1") & o("RV-Q3", "q3") & o("RV-Q2", "q2")
    if shape == "and_not":
        return o("RV-Q1", "q1") & ~o("RV-Q2", "q2")
    assert shape == "or_nested"
    return (o("RV-Q1", "q1") & ~o("RV-Q2", "q2")) | o("RV-Q3", "q3")


@pytest.mark.parametrize("shape", ["single", "and3", "and_not", "or_nested"])
def test_explain_then_collect_matches_reference(ds, shape):
    def run(side):
        sess = _session(side)
        t = sess.table(embeddings=ds.embeddings, name="reviews")
        q = _query(side, t, ds, shape)
        ex = q.explain()
        r = q.collect()
        return dict(text=ex.text, est=ex.est_oracle_calls,
                    pilot=ex.pilot_calls, order=ex.order,
                    nodes=_asdict(ex.nodes), result=_query_fields(r),
                    session_calls=sess.stats.n_calls, profile_lines=len(
                        r.profile().splitlines()))
    got = _both(run)
    assert got["session_calls"] == got["result"]["n_llm_calls"]
    # explain pays the memoized pilot; collect after it equals a cold one
    sess = _session("port")
    cold = _query("port", sess.table(embeddings=ds.embeddings, name="reviews"),
                  ds, shape).collect()
    assert _query_fields(cold)["mask"] == got["result"]["mask"]
    assert cold.n_llm_calls == got["result"]["n_llm_calls"]
    assert cold.pilot_calls == got["pilot"]


@pytest.mark.parametrize("policy", [
    dict(executor="round", pipeline_depth=1),
    dict(executor="round", pipeline_depth=3),
    dict(executor="sequential"),
    dict(method="csv-sim"),
    dict(method="csv-sim", shards=2),
    dict(epsilon=0.1, n_clusters=8),
])
def test_filter_policies_match_reference(ds, policy):
    def run(side):
        t = _session(side).table(embeddings=ds.embeddings)
        return _query_fields(t.filter(_oracle(side, ds), name="q").collect(
            _pol(side, xi=0.005, **policy)))
    got = _both(run)
    assert got["pilot_calls"] == 0 and got["order"] == ["q"]


@pytest.mark.parametrize("method,kw", [
    ("reference", {}), ("lotus", {"sample_size": 150}), ("bargain", {})])
def test_baselines_match_reference(ds, method, kw):
    def run(side):
        sess = _session(side)
        t = sess.table(embeddings=ds.embeddings)
        r = t.filter(_oracle(side, ds), name="b", proxy=_proxy(side, ds)
                     ).collect(_pol(side, method=method, baseline=kw))
        return dict(result=_query_fields(r), raw=_asdict(r.raw),
                    calls=sess.stats.n_calls,
                    proxy_calls=sess.proxy_stats.n_calls)
    got = _both(run)
    assert got["result"]["kind"] == "baseline"
    assert got["calls"] == got["result"]["n_llm_calls"]
    assert got["proxy_calls"] == got["result"]["n_proxy_calls"]
    assert got["proxy_calls"] == (0 if method == "reference" else N)


@pytest.mark.parametrize("method,nl,nr", [("csv", 240, 300),
                                          ("csv-sim", 60, 80)])
def test_join_matches_reference(ds, method, nl, nr):
    el, er = ds.embeddings[:nl], ds.embeddings[-nr:]
    truth = np.outer(ds.labels["RV-Q1"][:nl], ds.labels["RV-Q2"][-nr:])

    def run(side):
        sess = _session(side)
        hl = sess.table(embeddings=el, name="L")
        hr = sess.table(embeddings=er, name="R")
        o = SIDES[side][1](truth.ravel(), flip_prob=0.02, seed=3)
        q = hl.join(hr, o, policy=_pol(side, method=method))
        ex = q.explain()
        r1 = q.collect()
        r2 = q.collect()  # both tables unchanged: replayed in full
        return dict(text=ex.text, est=ex.est_oracle_calls,
                    r1=_query_fields(r1), raw=_asdict(r1.raw),
                    r2=_query_fields(r2), calls=o.stats.n_calls)
    got = _both(run)
    assert got["r1"]["kind"] == "join" and got["r2"]["n_llm_calls"] == 0
    assert got["r2"]["pair_mask"] == got["r1"]["pair_mask"]
    assert got["r2"]["n_replayed"] == nl * nr
    # the session's join is the direct sem_join on the session's clustering
    tl = SemanticTable(embeddings=el, init_centroids=jax_seeder, device="cpu")
    tr = SemanticTable(embeddings=er, init_centroids=jax_seeder, device="cpu")
    direct = sem_join(el, er, SyntheticOracle(truth.ravel(), flip_prob=0.02,
                                              seed=3),
                      JoinConfig(vote="sim" if method == "csv-sim" else "uni"),
                      assign_left=tl.precluster(4, 0),
                      assign_right=tr.precluster(4, 0),
                      init_centroids=jax_seeder, device="cpu")
    assert direct.pair_mask.tolist() == got["r1"]["pair_mask"]
    assert direct.n_llm_calls == got["r1"]["n_llm_calls"]


def test_join_rejects_baseline_methods(ds):
    sess = _session("port")
    hl = sess.table(embeddings=ds.embeddings[:100], name="jl")
    hr = sess.table(embeddings=ds.embeddings[:100], name="jr")
    q = hl.join(hr, SyntheticOracle(np.zeros(100 * 100, dtype=bool)))
    with pytest.raises(ValueError, match="not supported for joins"):
        q.collect(tapi.ExecutionPolicy(method="reference"))
    with pytest.raises(ValueError, match="not supported for joins"):
        q.explain(tapi.ExecutionPolicy(method="lotus"))


# ------------------------------------------------------- session memo
def _scenario(side, ds, name):
    """One reuse scenario of tests/test_session_reuse.py, as the sequence
    of its collects' QueryResults."""
    sess = _session(side)
    t = sess.table(embeddings=ds.embeddings, name="reviews")
    cold = _pol(side, n_clusters=4, reuse_memo=False, reuse_stats=False)
    if name == "warm_replay":
        o = _oracle(side, ds)
        rs = [t.filter(o, name="A").collect(), t.filter(o).collect()]
    elif name == "second_query":
        oA, oB = _oracle(side, ds, "RV-Q3", 0.0), _oracle(side, ds, "RV-Q1", 0.0)
        rs = [t.filter(oA, name="A").collect(),
              (t.filter(oA, name="A") & t.filter(oB, name="B")).collect()]
    elif name == "pilot_memo":
        oA, oB, oC = (_oracle(side, ds, q) for q in ("RV-Q1", "RV-Q2",
                                                     "RV-Q3"))
        rs = [(t.filter(oA, name="A") & t.filter(oB, name="B")).collect(),
              (t.filter(oA, name="A") & t.filter(oC, name="C")).collect()]
    elif name == "semantics":
        o = _oracle(side, ds)
        rs = [t.filter(o, name="A").collect(_pol(side, xi=0.005)),
              t.filter(o, name="A").collect(_pol(side, xi=0.02)),
              t.filter(o, name="A").collect(_pol(side, xi=0.005,
                                                 executor="sequential"))]
    elif name == "reuse_off":
        o = _oracle(side, ds)
        rs = [t.filter(o, name="A").collect(), t.filter(o, name="A").collect(
            cold)]
    else:
        assert name == "warm_explain_cold_collect"
        oA, oB = _oracle(side, ds, "RV-Q3", 0.0), _oracle(side, ds, "RV-Q1", 0.0)
        rs = [t.filter(oA, name="A").collect()]
        q = t.filter(oA, name="A") & t.filter(oB, name="B")
        q.explain()
        rs.append(q.collect(cold))
    return [_query_fields(r) for r in rs] + [sess.stats.n_calls]


@pytest.mark.parametrize("name", ["warm_replay", "second_query", "pilot_memo",
                                  "semantics", "reuse_off",
                                  "warm_explain_cold_collect"])
def test_session_reuse_matches_reference(ds, name):
    got = _both(lambda side: _scenario(side, ds, name))
    if name == "warm_replay":
        assert got[1]["n_llm_calls"] == 0 and got[1]["n_replayed"] == N
        assert got[1]["mask"] == got[0]["mask"]
    if name == "second_query":
        assert got[1]["n_replayed"] == N
    if name == "semantics":
        assert got[1]["n_replayed"] == 0 and got[2]["n_replayed"] == N


def test_budget_guard_matches_reference(ds):
    def run(side):
        t = _session(side).table(embeddings=ds.embeddings)
        o = _oracle(side, ds)
        tight = _pol(side, max_oracle_calls=5)
        with pytest.raises(SIDES[side][0].OracleBudgetError) as err:
            t.filter(o, name="A").collect(tight)
        spent = o.stats.n_calls  # the guard is closed-form
        r1 = t.filter(o, name="A").collect()
        r2 = t.filter(o, name="A").collect(tight)  # a warm replay fits
        return dict(msg=str(err.value), spent=spent,
                    r1=_query_fields(r1), r2=_query_fields(r2))
    got = _both(run)
    assert got["spent"] == 0 and got["r2"]["n_llm_calls"] == 0
    assert got["r2"]["mask"] == got["r1"]["mask"]


# ------------------------------------------------- incremental mutation
def _blobs(n_per=300, k=4, seed=0):
    """k well-separated clusters: k-means recovers them exactly."""
    rng = np.random.default_rng(seed)
    centers = np.eye(k, 3 if k <= 3 else k, dtype=np.float32) * 10.0
    emb = np.concatenate([
        centers[i] + rng.normal(0, 0.5, (n_per, centers.shape[1]))
        .astype(np.float32) for i in range(k)])
    labels = np.concatenate([np.full(n_per, bool(i % 2 == 0))
                             for i in range(k)])
    return centers, emb, labels


@pytest.mark.parametrize("kind", ["append", "update", "update_cold"])
def test_mutations_match_reference(kind):
    centers, emb, labels = _blobs()

    def run(side):
        sess = _session(side)
        # a copy each: update() writes the new rows into the table's array
        t = sess.table(embeddings=emb.copy(), name="blobs")
        pol = _pol(side, n_clusters=4, reuse_memo=kind != "update_cold",
                   reuse_stats=kind != "update_cold")
        if kind == "append":
            new = centers[0] + np.random.default_rng(99).normal(
                0, 0.5, (50, centers.shape[1])).astype(np.float32)
            oracle = SIDES[side][1](np.concatenate([labels,
                                                    np.ones(50, bool)]))
            r1 = t.filter(oracle, name="p").collect(pol)
            t.append(embeddings=new)
        else:
            oracle = SIDES[side][1](labels.copy())
            r1 = t.filter(oracle, name="p").collect(pol)
            upd = np.arange(300, 310)
            oracle.labels[upd] = True
            t.update(upd, embeddings=centers[2] + np.random.default_rng(3)
                     .normal(0, 0.5, (10, centers.shape[1]))
                     .astype(np.float32))
            assert not any(int(i) in oracle._memo for i in upd)
        r2 = t.filter(oracle, name="p").collect(pol)
        r3 = t.filter(oracle).collect(pol)
        return dict(r=[_query_fields(r) for r in (r1, r2, r3)],
                    version=t.version, n=len(t),
                    assign=sess._assign_cache[("blobs", 4, 0)],
                    dirty=t._dirty[(4, 0)])
    got = _both(run)
    r1, r2, r3 = got["r"]
    assert got["version"] == 1
    if kind != "update_cold":
        assert 0 < r2["n_replayed"] < got["n"]
        assert 0 < r2["n_llm_calls"] < r1["n_llm_calls"]
        assert r3["n_llm_calls"] == 0 and r3["n_replayed"] == got["n"]


def test_coalesced_appends_match_per_append():
    """Appends inside ``coalescing_appends()`` are one mutation (one
    version bump) whose later collect equals the per-append path's, as in
    the reference."""
    centers, emb, labels = _blobs()
    rng = np.random.default_rng(5)
    parts = [centers[i] + rng.normal(0, 0.5, (20, centers.shape[1]))
             .astype(np.float32) for i in (0, 0, 3)]
    grown = np.concatenate([labels, np.ones(40, bool), np.zeros(20, bool)])

    def run(side, coalesce):
        sess = _session(side)
        t = sess.table(embeddings=emb.copy(), name="blobs")
        oracle = SIDES[side][1](grown)
        pol = _pol(side, n_clusters=4)
        r1 = t.filter(oracle, name="p").collect(pol)
        if coalesce:
            with t.coalescing_appends():
                for part in parts:
                    t.append(embeddings=part)
                assert len(t) == len(emb)  # reads see the table before
        else:
            for part in parts:
                t.append(embeddings=part)
        r2 = t.filter(oracle, name="p").collect(pol)
        return dict(r=[_query_fields(r) for r in (r1, r2)],
                    version=t.version, dirty=t._dirty[(4, 0)],
                    assign=sess._assign_cache[("blobs", 4, 0)])
    batched = _both(lambda side: run(side, True))
    single = _both(lambda side: run(side, False))
    assert batched["version"] == 1 and single["version"] == 3
    np.testing.assert_array_equal(batched["assign"], single["assign"])
    for key in ("mask", "n_llm_calls", "n_replayed"):
        assert batched["r"][1][key] == single["r"][1][key]
    assert 0 < batched["r"][1]["n_replayed"] < len(emb) + 60


def test_mutation_argument_validation():
    _, emb, _ = _blobs(n_per=50)
    t = _session("port").table(embeddings=emb, name="b")
    with pytest.raises(ValueError, match="ids but"):
        t.update([1, 2, 3], embeddings=emb[:1])
    with pytest.raises(TypeError, match="append needs"):
        t.append()
    with pytest.raises(ValueError, match="shape"):
        t.append(embeddings=np.zeros((2, emb.shape[1] + 3), np.float32))
    assert len(t) == len(emb) and t.version == 0
    zeros = lambda ts: np.zeros((len(ts), 4), np.float32)  # noqa: E731
    lt = _session("port", embedder=zeros).table(texts=["a", "b"])
    with pytest.raises(ValueError, match="still lazy"):
        lt.append(texts=["c"], embeddings=np.zeros((1, 4), np.float32))
    assert len(lt) == 2 and lt.version == 0


def test_mutation_clears_join_pair_oracle_memo():
    _, emb, labels = _blobs(n_per=40)
    sess = _session("port")
    a = sess.table(embeddings=emb[:60], name="a")
    b = sess.table(embeddings=emb[:50], name="b")
    jo = SyntheticOracle(np.outer(labels[:60], labels[:50]).ravel())
    a.join(b, jo).collect()
    assert len(jo._memo) > 0
    a.update([0], embeddings=emb[100:101])
    assert len(jo._memo) == 0


# ------------------------------------------------------ embedding cache
def _counting_embedder(counter):
    def embed(texts):
        counter["rows"] += len(texts)
        return np.stack([np.frombuffer(t.encode("utf-8").ljust(8)[:8],
                                       np.uint8).astype(np.float32)
                         for t in texts])
    return embed


def test_embedding_cache_embeds_only_new_rows():
    counter = {"rows": 0}
    texts = [f"tuple number {i}" for i in range(60)]
    sess = _session("port", embedder=_counting_embedder(counter))
    t1 = sess.table(texts=texts)
    assert len(t1.embeddings) == 60 and counter["rows"] == 60
    t2 = sess.table(texts=texts[:40] + [f"fresh {i}" for i in range(20)])
    _ = t2.embeddings
    assert counter["rows"] == 80
    t1.append(texts=[f"appended {i}" for i in range(5)])
    assert counter["rows"] == 85 and len(t1) == 65
    assert sess.embedding_cache.hits >= 40
    shared = tapi.EmbeddingCache()
    for _ in range(2):
        s = _session("port", embedder=_counting_embedder(counter),
                     embedding_cache=shared)
        _ = s.table(texts=texts).embeddings
    assert counter["rows"] == 145 and shared.hits == 60


# -------------------------------------------------------------- audit
def test_audit_matches_reference(ds):
    """The audit report equals the reference's, and auditing observes
    only: masks, calls and oracle memos as without it."""
    def run(side, rate):
        sess = _session(side, policy=_pol(side, n_clusters=4, xi=0.005,
                                          audit_rate=rate))
        t = sess.table(embeddings=ds.embeddings, name="reviews")
        o1, o2 = _oracle(side, ds), _oracle(side, ds, "RV-Q3")
        r = (t.filter(o1, name="q1") & ~t.filter(o2, name="q3")).collect()
        return dict(r=_query_fields(r), memo=len(o1._memo) + len(o2._memo),
                    calls=o1.stats.n_calls + o2.stats.n_calls,
                    text=str(r.audit) if r.audit is not None else None)
    off = _both(lambda side: run(side, 0.0))
    on = _both(lambda side: run(side, 0.3))
    assert off["r"]["audit"] is None and on["r"]["audit"]["n_audited"] > 0
    assert (on["memo"], on["calls"]) == (off["memo"], off["calls"])
    assert on["r"]["mask"] == off["r"]["mask"]
    t = _session("port").table(embeddings=ds.embeddings)
    with pytest.raises(ValueError, match="no audit attached"):
        t.filter(_oracle("port", ds), name="q").collect().audit_report()


def test_audit_metrics_match_reference(ds):
    """The traced run's counters (audit spend apart from oracle spend) and
    a later un-audited query equal the reference's; an audited first
    query leaves the second one as it is without the audit."""
    from repro.obs import MetricsRegistry as JRegistry
    from repro.obs import Tracer as JTracer
    from repro.obs import use_tracer as j_use_tracer
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.trace import Tracer, use_tracer
    tracing = {"ref": (JTracer, JRegistry, j_use_tracer),
               "port": (Tracer, MetricsRegistry, use_tracer)}
    keys = ("audit.calls", "audit.cached", "audit.input_tokens",
            "quality.audited_rows", "quality.disagreements",
            "quality.accuracy", "quality.accuracy_lo", "oracle.calls",
            "oracle.input_tokens", "driver.voted", "driver.fallback",
            "query.collects")

    def run(side, rate):
        tracer_cls, registry_cls, use = tracing[side]
        pol = _pol(side, n_clusters=4, xi=0.005)
        sess = _session(side, policy=pol)
        t = sess.table(embeddings=ds.embeddings, name="reviews")
        o1 = _oracle(side, ds, "RV-Q1", flip=0.05)
        tr = tracer_cls(metrics=registry_cls())
        with use(tr):
            r1 = t.filter("q", o1).collect(pol.replace(audit_rate=rate))
        snap = tr.metrics.snapshot()
        o2 = SIDES[side][1](ds.labels["RV-Q2"], flip_prob=0.05, seed=9,
                            token_lens=ds.token_lens)
        r2 = t.filter("q2", o2).collect()
        return dict(snap={k: snap.get(k) for k in keys},
                    margins=snap["quality.vote_margin"]["count"],
                    oracle_calls=o1.stats.n_calls, r1=_query_fields(r1),
                    r2=_query_fields(r2))
    on = _both(lambda side: run(side, 0.3))
    off = _both(lambda side: run(side, 0.0))
    assert on["snap"]["oracle.calls"] == on["oracle_calls"]
    assert on["margins"] > 0
    rep = on["r1"]["audit"]
    assert on["snap"]["quality.audited_rows"] == rep["n_audited"] == (
        on["snap"]["audit.calls"] + on["snap"]["audit.cached"]) > 0
    assert off["r1"]["audit"] is None
    for key in ("mask", "n_llm_calls"):
        assert on["r1"][key] == off["r1"][key]
    assert on["r2"] == off["r2"]


def test_wilson_interval_and_stratified_sample_match_reference():
    from repro.obs import audit as jaudit
    from repro_torch.obs import audit as taudit
    for k, n in ((90, 100), (0, 0), (0, 50), (50, 50), (900, 1000)):
        assert taudit.wilson_interval(k, n) == jaudit.wilson_interval(k, n)
    assign = np.random.default_rng(0).integers(0, 5, 700)
    for rate, cap, seed in ((0.1, 256, 0), (0.5, 64, 3), (0.001, 10, 1)):
        np.testing.assert_array_equal(
            taudit.stratified_sample(assign, rate, cap, seed),
            jaudit.stratified_sample(assign, rate, cap, seed))


# ------------------------------------------------- session-level state
def test_two_tables_never_share_precluster_assignments(ds):
    rng = np.random.default_rng(0)
    sess = _session("port")
    a = sess.table(embeddings=ds.embeddings, name="a")
    b = sess.table(embeddings=rng.normal(size=ds.embeddings.shape), name="b")
    assign_a, assign_b = a.precluster(4, seed=0), b.precluster(4, seed=0)
    assert {("a", 4, 0), ("b", 4, 0)} <= set(sess._assign_cache)
    assert not (assign_a == assign_b).all()
    assert a.precluster(4, seed=0) is assign_a
    ref = japi.Session().table(embeddings=ds.embeddings).precluster(4, 0)
    np.testing.assert_array_equal(assign_a, ref)


def test_registry_and_table_rules(ds):
    sess = _session("port")
    t = sess.table(embeddings=ds.embeddings)
    sess.register_oracle("positive", _oracle("port", ds),
                         proxy=_proxy("port", ds))
    q = t.filter("positive")
    assert q.expr.name == "positive" and q.proxy is not None
    with pytest.raises(ValueError, match="already registered"):
        sess.register_oracle("positive", _oracle("port", ds))
    with pytest.raises(KeyError, match="no oracle registered"):
        t.filter("missing")
    st = SemanticTable(embeddings=ds.embeddings, device="cpu")
    h1 = sess.table(table=st)
    assert sess.table(table=st) is h1 and sess[h1.name] is h1
    with pytest.raises(ValueError, match="already registered"):
        sess.table(table=st, name="other")


def test_policy_validation_and_conversions():
    with pytest.raises(ValueError, match="unknown method"):
        tapi.ExecutionPolicy(method="nope")
    with pytest.raises(ValueError, match="unknown executor"):
        tapi.ExecutionPolicy(executor="warp")
    with pytest.raises(ValueError, match="pipeline_depth"):
        tapi.ExecutionPolicy(pipeline_depth=0)
    for kw in (dict(), dict(method="csv-sim", shards=3, epsilon=0.1),
               dict(vote="sim", n_clusters_right=6, max_refine=2)):
        got, want = tapi.ExecutionPolicy(**kw), japi.ExecutionPolicy(**kw)
        assert (dataclasses.asdict(got.to_csv_config())
                == dataclasses.asdict(want.to_csv_config()))
        assert (dataclasses.asdict(got.to_join_config())
                == dataclasses.asdict(want.to_join_config()))
        assert (dataclasses.asdict(tapi.ExecutionPolicy.from_csv_config(
            got.to_csv_config())) == dataclasses.asdict(
            japi.ExecutionPolicy.from_csv_config(want.to_csv_config())))


def test_query_validation(ds):
    sess = _session("port")
    t = sess.table(embeddings=ds.embeddings, name="a")
    u = sess.table(embeddings=ds.embeddings, name="b")
    o = _oracle("port", ds)
    with pytest.raises(ValueError, match="same table"):
        _ = t.filter(o, name="x") & u.filter(o, name="y")
    with pytest.raises(ValueError, match="requires a proxy"):
        t.filter(o, name="x").collect(tapi.ExecutionPolicy(method="lotus"))
    with pytest.raises(ValueError, match="single bare predicate"):
        (t.filter(o, name="x") & t.filter(_oracle("port", ds, "RV-Q3"),
                                          name="y")).collect(
            tapi.ExecutionPolicy(method="reference"))
    with pytest.raises(ValueError, match="conflicting ExecutionPolicies"):
        _ = (t.filter(o, name="x", policy=tapi.ExecutionPolicy(xi=0.02))
             & t.filter(o, name="x", policy=tapi.ExecutionPolicy(
                 method="csv-sim")))
    with pytest.raises(TypeError):
        t.filter(12345)
    with pytest.raises(ValueError, match="texts and/or embeddings"):
        SemanticTable(device="cpu")


def test_service_is_not_ported(ds):
    """The service is ported now: ``submit``/``gather`` give the
    reference's result for the same query (tests/test_torch_service.py
    holds the full service cases)."""
    def run(side):
        sess = _session(side)
        q = sess.table(embeddings=ds.embeddings).filter(_oracle(side, ds))
        try:
            (r,) = sess.gather(sess.submit(q))
        finally:
            sess.close()
        return _query_fields(r)
    _both(run)


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(ds,
                                                             monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    e = ds.embeddings[:50]
    for call in (lambda: tapi.Session(), lambda: SemanticTable(embeddings=e),
                 lambda: sem_join(e, e, SyntheticOracle(np.zeros(2500, bool)))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert tapi.Session(device="cpu").device.type == "cpu"
    # a table on another device than its session is refused
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="session on cpu"):
        tapi.Session(device="cpu").table(
            table=SemanticTable(embeddings=e, device="cuda"))


# ------------------------------------------------------- quality metrics
@pytest.mark.parametrize("case", ["random", "all_false", "perfect"])
def test_accuracy_f1_matches_reference(case):
    rng = np.random.default_rng(11)
    truth = rng.random(400) < 0.3
    pred = {"random": rng.random(400) < 0.4,
            "all_false": np.zeros(400, bool),
            "perfect": truth.copy()}[case]
    assert accuracy_f1(pred, truth) == j_accuracy_f1(pred, truth)
