"""The port's plan layer (expressions, cost model, optimizer, cascades) and
semantic join against the JAX reference.

Same tables, same oracle seeds, the reference's k-means++ injected through
the port's seeder hook: masks, call counts, ``PlanResult.order``,
``node_log``, per-node ``cluster_log``/``round_log``, the optimizer's
estimates and the join's pair masks and round logs are equal, on the CPU.
Modelled on tests/test_plan.py and tests/test_plan_join.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import plan as jplan
from repro.core import CSVConfig as JCSVConfig
from repro.core import SemanticTable as JSemanticTable
from repro.core import bm25 as jbm25
from repro.core import clustering as jc
from repro.core import voting as jvoting
from repro.core.csv_filter import semantic_filter as j_semantic_filter
from repro.core.oracle import SyntheticOracle as JSyntheticOracle
from repro.data import make_dataset
from repro_torch import plan as tplan
from repro_torch.core import CSVConfig, SemanticTable
from repro_torch.core import bm25 as tbm25
from repro_torch.core import voting as tvoting
from repro_torch.core.csv_filter import semantic_filter
from repro_torch.core.oracle import SyntheticOracle

_plusplus = jax.jit(jc._plusplus_init, static_argnums=2)


def jax_seeder(seed, x, k):
    """The reference's k-means++ for ``jax.random.key(seed)``."""
    return np.asarray(_plusplus(jax.random.key(seed), jnp.asarray(x), k))


@pytest.fixture(scope="module")
def ds():
    return make_dataset("imdb_review", n=3000, seed=0)


SIDES = {"ref": (jplan, JSyntheticOracle, JCSVConfig),
         "port": (tplan, SyntheticOracle, CSVConfig)}


def _table(side, ds):
    if side == "ref":
        return JSemanticTable(texts=ds.texts, embeddings=ds.embeddings)
    return SemanticTable(texts=ds.texts, embeddings=ds.embeddings,
                         init_centroids=jax_seeder, device="cpu")


def _result_fields(fr):
    """A FilterResult without its wall times."""
    d = dataclasses.asdict(fr)
    d.pop("total_time_s")
    d.pop("recluster_time_s")
    d["mask"] = d["mask"].tolist()
    return d


def _node_fields(rec):
    d = {f.name: getattr(rec, f.name) for f in dataclasses.fields(rec)
         if f.name != "result"}
    d["result"] = None if rec.result is None else _result_fields(rec.result)
    return d


def assert_same_plan(got, ref):
    np.testing.assert_array_equal(got.mask, ref.mask)
    for field in ("n_llm_calls", "pilot_calls", "input_tokens",
                  "output_tokens", "order", "naive_order"):
        assert getattr(got, field) == getattr(ref, field), field
    assert ([_node_fields(r) for r in got.node_log]
            == [_node_fields(r) for r in ref.node_log])
    assert ({k: dataclasses.asdict(v) for k, v in got.pilot_stats.items()}
            == {k: dataclasses.asdict(v) for k, v in ref.pilot_stats.items()})
    if ref.estimate is None:
        assert got.estimate is None
    else:
        for field in ("order", "naive_order", "est_tokens_ordered",
                      "est_tokens_naive", "est_calls_ordered",
                      "est_calls_naive"):
            assert (getattr(got.estimate, field)
                    == getattr(ref.estimate, field)), field
        assert got.estimate.ordered.label == ref.estimate.ordered.label


# ------------------------------------------------------------------ AST
def test_operator_composition_matches_reference():
    for mod in (jplan, tplan):
        a, b, c = (mod.Pred(n, oracle=None) for n in "abc")
        expr = (a & b) & ~c
        assert isinstance(expr, mod.And) and len(expr.children) == 3
        assert [p.name for p in expr.leaves()] == ["a", "b", "c"]
        assert expr.label == "(a AND b AND NOT c)"
        assert mod.needs_ordering(expr)
        assert not mod.needs_ordering(a) and not mod.needs_ordering(~a)
        assert (((a | b) & c).label
                == "((a OR b) AND c)")
        with pytest.raises(TypeError):
            mod.And(a, "not an expr")


def test_duplicate_name_with_different_oracles_rejected(ds):
    table = _table("port", ds)
    expr = (tplan.Pred("q", SyntheticOracle(ds.labels["RV-Q1"]))
            & tplan.Pred("q", SyntheticOracle(ds.labels["RV-Q2"])))
    with pytest.raises(ValueError, match="unique name"):
        tplan.PlanExecutor(table, cfg=CSVConfig()).run(expr)


# --------------------------------------------------------- cascades
def _expr(mod, oracle_cls, ds, shape, flip=0.02):
    def p(name, q=None):
        return mod.Pred(name, oracle_cls(ds.labels[q or name], flip_prob=flip,
                                         seed=7, token_lens=ds.token_lens))
    if shape == "single":
        return p("RV-Q1")
    if shape == "and3":
        return mod.And(p("RV-Q1"), p("RV-Q2"), p("RV-Q3"))
    if shape == "or2":
        return mod.Or(p("RV-Q3"), p("RV-Q1"))
    if shape == "and_not":
        return p("RV-Q1") & ~p("RV-Q2")
    assert shape == "nested"
    return (p("q1", "RV-Q1") & ~p("q2", "RV-Q2")) | p("q3", "RV-Q3")


@pytest.mark.parametrize("shape,optimize,n", [
    ("single", True, 3000), ("and3", True, 3000), ("and3", False, 3000),
    ("or2", True, 3000), ("or2", False, 3000), ("and_not", True, 3000),
    ("nested", True, 260)])
def test_plan_matches_reference(ds, shape, optimize, n):
    data = ds if n == len(ds.embeddings) else make_dataset(
        "imdb_review", n=n, seed=3)
    flip = 0.0 if shape == "nested" else 0.02
    runs = {}
    for side, (mod, oracle_cls, cfg_cls) in SIDES.items():
        ex = mod.PlanExecutor(_table(side, data),
                              cfg=cfg_cls(n_clusters=4, xi=0.005),
                              optimize=optimize)
        runs[side] = ex.run(_expr(mod, oracle_cls, data, shape, flip))
    assert_same_plan(runs["port"], runs["ref"])
    got = runs["port"]
    if shape == "single":
        assert got.pilot_calls == 0 and got.order == ["RV-Q1"]
    if shape == "and3":
        assert got.node_log[0].n_in == len(data.embeddings)
        assert got.node_log[1].n_in == got.node_log[0].n_out
        if optimize:
            assert got.order[0] == "RV-Q3" and got.est_calls_saved > 0
    if shape == "nested":  # every cluster exhausted: CSV is exact
        truth = ((data.labels["RV-Q1"] & ~data.labels["RV-Q2"])
                 | data.labels["RV-Q3"])
        np.testing.assert_array_equal(got.mask, truth)


def test_plan_prepare_then_run_matches_single_run(ds):
    """Planning and execution split (explain, then collect) are equal to
    one run: the pilot's calls are memoized."""
    table = _table("port", ds)
    cfg = CSVConfig(n_clusters=4, xi=0.005)
    cold = tplan.PlanExecutor(table, cfg=cfg).run(
        _expr(tplan, SyntheticOracle, ds, "and3"))
    expr = _expr(tplan, SyntheticOracle, ds, "and3")
    ex = tplan.PlanExecutor(table, cfg=cfg)
    warm = ex.run(expr, prepared=ex.prepare(expr))
    np.testing.assert_array_equal(warm.mask, cold.mask)
    assert (warm.n_llm_calls, warm.pilot_calls, warm.order) == (
        cold.n_llm_calls, cold.pilot_calls, cold.order)


def test_plan_reuses_the_table_precluster(ds):
    table = _table("port", ds)
    tplan.PlanExecutor(table, cfg=CSVConfig(n_clusters=4, xi=0.005)).run(
        _expr(tplan, SyntheticOracle, ds, "and3"))
    assert list(table._assign_cache) == [(4, 0)]
    ref = _table("ref", ds)
    np.testing.assert_array_equal(table.precluster(4, 0),
                                  ref.precluster(4, 0))


@pytest.mark.parametrize("kind", ["subset", "empty", "subset_assign"])
def test_semantic_filter_subset_matches_reference(ds, kind):
    cfg = dict(n_clusters=4, xi=0.005)
    assign = _table("ref", ds).precluster(4, 0)
    subset = {"subset": np.arange(0, len(ds.embeddings), 3),
              "empty": np.array([], dtype=np.int64),
              "subset_assign": np.nonzero(ds.labels["RV-Q2"])[0]}[kind]
    kw = dict(subset_ids=subset,
              precomputed_assign=assign if kind == "subset_assign" else None)
    ref = j_semantic_filter(
        ds.embeddings, JSyntheticOracle(ds.labels["RV-Q1"], flip_prob=0.02,
                                        seed=7), JCSVConfig(**cfg), **kw)
    got = semantic_filter(
        ds.embeddings, SyntheticOracle(ds.labels["RV-Q1"], flip_prob=0.02,
                                       seed=7), CSVConfig(**cfg),
        init_centroids=jax_seeder, device="cpu", **kw)
    assert _result_fields(got) == _result_fields(ref)
    assert not got.mask[np.setdiff1d(np.arange(len(ds.embeddings)),
                                     subset)].any()


# ----------------------------------------------------- cost model unit
def test_pilot_estimate_and_optimize_match_reference(ds):
    live = np.arange(len(ds.embeddings))
    stats, leaves = {}, {}
    for side, (mod, oracle_cls, _) in SIDES.items():
        leaves[side] = [mod.Pred(q, oracle_cls(ds.labels[q], flip_prob=0.02,
                                               seed=7,
                                               token_lens=ds.token_lens))
                        for q in ("RV-Q1", "RV-Q2", "RV-Q3")]
        stats[side] = mod.pilot_predicates(
            leaves[side], live, np.random.default_rng(5), 32)
    assert ({k: dataclasses.asdict(v) for k, v in stats["port"].items()}
            == {k: dataclasses.asdict(v) for k, v in stats["ref"].items()})
    for n in (0, 50, 101, 102, 3000, 10 ** 6):
        for cfg in (dict(), dict(n_clusters=8, xi=0.02),
                    dict(epsilon=0.05, vote="sim")):
            assert (tplan.est_oracle_calls(n, CSVConfig(**cfg))
                    == jplan.est_oracle_calls(n, JCSVConfig(**cfg)))
    for side, (mod, _, cfg_cls) in SIDES.items():
        a, b, c = leaves[side]
        expr = mod.Or(mod.And(a, ~b), c)
        est = mod.optimize(expr, len(live), stats[side], cfg_cls())
        stats[side] = (est.order, est.naive_order, est.est_calls_ordered,
                       est.est_tokens_ordered, est.est_calls_naive,
                       [dataclasses.asdict(nd) for nd in mod.node_estimates(
                           est.ordered, len(live), stats[side], cfg_cls())])
    assert stats["port"] == stats["ref"]


# ------------------------------------------------------------------ join
def _sides(nl, nr, n_topics=4):
    return (make_dataset("imdb_review", n=nl, seed=1, n_topics=n_topics),
            make_dataset("imdb_review", n=nr, seed=2, n_topics=n_topics))


def _join_case(case):
    """(left, right, pair truth, JoinConfig kwargs, flip) of one case."""
    if case == "checkerboard":
        dl, dr = _sides(40, 40)
        ii = np.arange(40)
        truth = ((ii[:, None] + ii[None, :]) % 2).astype(bool)
        return dl, dr, truth, dict(n_clusters_left=2, n_clusters_right=2,
                                   max_refine=2), 0.0
    nl, nr, kw, flip = {
        "exhausted": (20, 20, dict(), 0.0),
        "sublinear": (400, 300, dict(), 0.0),
        "noisy": (400, 300, dict(), 0.02),
        "sim": (60, 60, dict(n_clusters_left=3, n_clusters_right=3,
                             vote="sim"), 0.0),
    }[case]
    dl, dr = _sides(nl, nr)
    truth = (dl.topics[:, None] % 2) == (dr.topics[None, :] % 2)
    return dl, dr, truth, kw, flip


@pytest.mark.parametrize("case", ["exhausted", "sublinear", "noisy",
                                  "checkerboard", "sim"])
def test_join_matches_reference(case):
    dl, dr, truth, kw, flip = _join_case(case)
    ref = jplan.sem_join(dl.embeddings, dr.embeddings,
                         JSyntheticOracle(truth.ravel(), flip_prob=flip,
                                          seed=3),
                         jplan.JoinConfig(**kw))
    got = tplan.sem_join(dl.embeddings, dr.embeddings,
                         SyntheticOracle(truth.ravel(), flip_prob=flip,
                                         seed=3),
                         tplan.JoinConfig(**kw), init_centroids=jax_seeder,
                         device="cpu")
    np.testing.assert_array_equal(got.pair_mask, ref.pair_mask)
    for field in ("n_llm_calls", "input_tokens", "output_tokens", "n_voted",
                  "n_fallback", "refine_rounds"):
        assert getattr(got, field) == getattr(ref, field), field
    assert ([dataclasses.asdict(r) for r in got.round_log]
            == [dataclasses.asdict(r) for r in ref.round_log])
    sampled = sum(rr.n_sampled for rr in got.round_log)
    assert sampled + got.n_voted + got.n_fallback == truth.size
    if case in ("exhausted", "checkerboard"):
        np.testing.assert_array_equal(got.pair_mask, truth)
    if case == "checkerboard":
        assert got.refine_rounds >= 1 and got.n_fallback > 0
    if case == "sim":  # SimVote blocks, then one 2-means refinement
        assert got.refine_rounds == 1 and got.n_voted > 0
    if case == "sublinear":
        assert got.n_llm_calls < 0.25 * truth.size


@pytest.mark.parametrize("sides", ["numpy", "tensor"])
def test_join_pair_rows_and_their_votes_match_reference(sides):
    """The join gathers its unsampled pair rows from tensors on the device;
    the rows and the SimVote decisions over them equal the reference's
    host-built rows."""
    dl, dr = _sides(50, 40)
    el, er = dl.embeddings.astype(np.float32), dr.embeddings.astype(np.float32)
    rng = np.random.default_rng(5)
    blocks = [(rng.integers(0, 50, n), rng.integers(0, 40, n))
              for n in (70, 1, 130)]
    samples = [(rng.integers(0, 50, m), rng.integers(0, 40, m))
               for m in (12, 9, 20)]
    labels = [rng.random(len(li)) < 0.5 for li, _ in samples]
    want_rows = [jplan.join._pair_embs(el, er, li, rj) for li, rj in blocks]
    if sides == "tensor":
        el_s, er_s = torch.as_tensor(el), torch.as_tensor(er)
    else:
        el_s, er_s = el, er
    rows = [tplan.join._pair_embs(el_s, er_s, li, rj) for li, rj in blocks]
    for got, want in zip(rows, want_rows):
        assert isinstance(got, torch.Tensor) == (sides == "tensor")
        np.testing.assert_array_equal(np.asarray(got), want)
    emb_sampled = [jplan.join._pair_embs(el, er, li, rj)
                   for li, rj in samples]
    got = tvoting.vote_clusters("sim", labels, [len(r) for r in rows],
                                0.15, 0.85, emb_unsampled=rows,
                                emb_sampled=emb_sampled, device="cpu")
    want = jvoting.vote_clusters("sim", labels, [len(r) for r in want_rows],
                                 0.15, 0.85, emb_unsampled=want_rows,
                                 emb_sampled=emb_sampled)
    for g, w in zip(got, want):
        for field in ("decided_true", "decided_false", "undetermined"):
            np.testing.assert_array_equal(getattr(g, field),
                                          getattr(w, field))


def test_pair_ids_match_reference():
    i, j = np.array([0, 1, 2, 9]), np.array([5, 0, 3, 6])
    pid = tplan.pair_ids(i, j, n_right=7)
    np.testing.assert_array_equal(pid, jplan.pair_ids(i, j, n_right=7))
    assert (pid // 7 == i).all() and (pid % 7 == j).all()
    assert pid.dtype == np.int64


# ------------------------------------------------------------------ bm25
def test_bm25_features_match_reference():
    data = make_dataset("imdb_review", n=120, seed=4)
    np.testing.assert_array_equal(tbm25.bm25_vectors(data.texts, dim=64),
                                  jbm25.bm25_vectors(data.texts, dim=64))
    for lam in (1.0, 0.7, 0.0):
        np.testing.assert_array_equal(
            tbm25.hybrid_features(data.embeddings, data.texts, lam=lam,
                                  bm25_dim=32),
            jbm25.hybrid_features(data.embeddings, data.texts, lam=lam,
                                  bm25_dim=32))
