"""The port's own spans (``PORT_ONLY_KINDS``): the CSV driver's host steps
(kind "step") as leaves under ``vote`` and ``partition``, the model's
layer kinds (kind "layer") under ``engine_tick``, and ``epoch_ns``, which
puts a span's time on the clock ``torch.profiler`` stamps its events on.
"""
import collections

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.core.clustering import kmeans
from repro_torch.core.csv_filter import CSVConfig, semantic_filter
from repro_torch.core.oracle import SyntheticOracle
from repro_torch.data.synthetic import make_dataset
from repro_torch.models import lm
from repro_torch.obs.trace import Tracer, clock_anchor, epoch_ns, use_tracer
from repro_torch.serving import ServingEngine

PARENTS = {"gather_rows": {"vote", "partition"}, "vote_pack": {"vote"},
           "to_device": {"vote", "partition"},
           "kmeans_seed": {"partition"}, "kmeans_lloyd": {"partition"}}


@pytest.fixture(scope="module")
def filtered():
    """One sim-vote filter with one re-clustering round, traced and not,
    from a pre-clustering made outside the trace (as a table's cached
    one is)."""
    ds = make_dataset("imdb_review", n=1500, seed=0)
    cfg = CSVConfig(n_clusters=4, xi=0.005, vote="sim")
    _, assign, _ = kmeans(0, ds.embeddings, 4, device="cpu")
    assign = assign.numpy()

    def run(tracer):
        oracle = SyntheticOracle(ds.labels["RV-Q1"], flip_prob=0.02, seed=7)
        with use_tracer(tracer):
            return semantic_filter(ds.embeddings, oracle, cfg,
                                   precomputed_assign=assign, device="cpu")
    tr = Tracer()
    return ds, tr, run(tr), run(None)


def test_driver_steps_are_leaves_under_vote_and_partition(filtered):
    _, tr, res, _ = filtered
    assert res.recluster_rounds == 1
    spans = tr.spans()
    by_id = {s.span_id: s for s in spans}
    steps = [s for s in spans if s.kind == "step"]
    assert {s.name for s in steps} == set(PARENTS)
    for s in steps:
        assert by_id[s.parent_id].name in PARENTS[s.name], s
    seen = {(s.name, by_id[s.parent_id].name) for s in steps}
    assert seen == {(n, p) for n, ps in PARENTS.items() for p in ps}
    step_ids = {s.span_id for s in steps}
    assert not any(s.parent_id in step_ids for s in spans)
    lloyd = [s for s in steps if s.name == "kmeans_lloyd"]
    assert lloyd and all(s.attrs["iters"] >= 1 for s in lloyd)


def test_to_device_bytes_are_the_rows_moved(filtered):
    ds, tr, res, _ = filtered
    d = ds.embeddings.shape[1]
    spans = tr.spans()
    by_id = {s.span_id: s for s in spans}
    copies = [s for s in spans if s.name == "to_device"]
    assert {s.attrs["of"] for s in copies} == {"x", "vote", "centroids"}
    for s in copies:
        # a vote's copy: its rows, the padded samples and their labels
        samples = s.attrs.get("samples", 0)
        assert s.attrs["bytes"] == ((s.attrs["rows"] + samples) * d * 4
                                    + samples * 4), s.attrs
    for s in spans:
        if s.name == "gather_rows":
            assert s.attrs["bytes"] == s.attrs["rows"] * d * 4
    # the votes' unsampled rows are the rows no sample and no vote of
    # another round decided; the re-cluster moves its pending rows
    voted = sum(c["size"] - c["sampled"] for c in res.cluster_log)
    assert sum(s.attrs["rows"] for s in copies
               if by_id[s.parent_id].name == "vote") == voted
    assert all(s.attrs["of"] == "vote" for s in copies
               if by_id[s.parent_id].name == "vote")
    pending = [s.attrs["n_pending"] for s in spans if s.name == "partition"]
    assert [s.attrs["rows"] for s in copies if s.attrs["of"] == "x"
            and by_id[s.parent_id].name == "partition"] == pending


def test_traced_filter_decides_as_the_untraced(filtered):
    _, _, traced, plain = filtered
    np.testing.assert_array_equal(traced.mask, plain.mask)
    assert traced.n_llm_calls == plain.n_llm_calls


def test_layer_kind_spans_nest_in_engine_ticks():
    cfg = smoke_config("jamba-v0.1-52b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    eng = ServingEngine(cfg, params, max_batch=4, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(8, 500, int(n)).tolist()
               for n in rng.integers(3, 40, 6)]
    tr = Tracer()
    with use_tracer(tr):
        traced = eng.first_token_logits(prompts, token_ids=[1, 2])
    spans = tr.spans()
    ticks = [s for s in spans if s.kind == "engine_tick"]
    layers = [s for s in spans if s.kind == "layer"]
    assert len(ticks) >= 2
    n_sb = cfg.n_layers // len(cfg.pattern)
    want = collections.Counter()
    for i, spec in enumerate(cfg.pattern):
        want[(spec.kind, i)] += n_sb
        if spec.ffn in ("dense", "moe"):
            want[("mlp" if spec.ffn == "dense" else "moe", i)] += n_sb
    assert {k for k, _ in want} == {"attn", "mamba", "mlp", "moe"}
    for t in ticks:
        mine = [s for s in layers if s.parent_id == t.span_id]
        assert collections.Counter((s.name, s.attrs["layer"])
                                   for s in mine) == want
    assert all(s.parent_id in {t.span_id for t in ticks} for s in layers)
    layer_ids = {s.span_id for s in layers}
    assert not any(s.parent_id in layer_ids for s in spans)
    # tracing observes only: the same logits untraced
    np.testing.assert_array_equal(
        eng.first_token_logits(prompts, token_ids=[1, 2]), traced)


def test_epoch_ns_puts_a_span_on_the_profiler_clock():
    tr = Tracer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(4):  # the first entries warm the range up
            with tr.span("probe", kind="probe", i=i):
                with torch.profiler.record_function(f"probe{i}"):
                    pass
    start = {ev.name(): ev.start_ns()
             for ev in prof.profiler.kineto_results.events()}
    last = tr.spans()[-1]
    lag = start["probe3"] - epoch_ns(last.t0)
    assert abs(lag) < 100_000, lag


def test_epoch_ns_maps_arrays_as_scalars():
    m, w = clock_anchor()
    t = np.array([m / 1e9, m / 1e9 + 2.5])
    got = epoch_ns(t)
    assert got.dtype == np.int64
    assert abs(int(got[0]) - w) < 100_000
    assert abs(int(got[1] - got[0]) - 2_500_000_000) < 1_000
    assert abs(epoch_ns(m / 1e9) - int(got[0])) < 1_000

