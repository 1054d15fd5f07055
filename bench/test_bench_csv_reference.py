"""The reference CSV against the port's CSV driver at smoke size on the CPU:
the same masks, oracle calls and cluster log, and the pre-clustering
equal to the port's k-means, the port under its own default seeding."""
import numpy as np
import pytest
import torch

from benchkit import csv_ref, data
from repro_torch.core.clustering import kmeans
from repro_torch.core.csv_filter import CSVConfig, semantic_filter
from repro_torch.core.oracle import SyntheticOracle


class _Recording(SyntheticOracle):
    def __init__(self, labels):
        super().__init__(labels)
        self.asked = []

    def _evaluate(self, ids):
        self.asked.append(np.asarray(ids))
        return super()._evaluate(ids)


def _table(smoke, rows, dim):
    cs = smoke(rows=rows, dim=dim)
    return cs["mix"], data.Table(cs["mix"], "cpu")


@pytest.mark.parametrize("rows,dim,seed", [(3000, 64, 0), (3000, 64, 7),
                                           (2000, 32, 3), (4000, 48, 11)])
def test_reference_csv_equals_the_port(smoke, rows, dim, seed):
    mix, table = _table(smoke, rows, dim)
    pol = dict(mix["policy"])
    emb = table.emb.double()
    assign0, tie0 = csv_ref.kmeans(pol["seed"], emb, table.emb_host,
                                   pol["n_clusters"], pol["kmeans_iters"],
                                   csv_ref.plusplus, "f64")
    _, port_assign, _ = kmeans(pol["seed"], table.emb_host, pol["n_clusters"],
                               device="cpu")
    assert not tie0
    np.testing.assert_array_equal(port_assign.numpy(), assign0)
    labels = data.query_labels(table, mix, seed, 0)
    ref = csv_ref.csv_filter(emb, table.emb_host, labels, assign0, pol,
                             csv_ref.plusplus)
    oracle = _Recording(labels)
    cfg = CSVConfig(vote="sim", **{k: pol[k] for k in (
        "n_clusters", "xi", "min_sample", "lb", "max_recluster",
        "kmeans_iters", "seed")})
    res = semantic_filter(table.emb_host, oracle, cfg,
                          precomputed_assign=assign0, device="cpu")
    assert ref.followed > 0
    f = ref.followed
    for got, want in zip(oracle.asked[:f], ref.calls[:f]):
        np.testing.assert_array_equal(got, want)
    if f == len(ref.calls):
        assert len(oracle.asked) == len(ref.calls)
        assert res.n_llm_calls == sum(len(c) for c in ref.calls)
        np.testing.assert_array_equal(res.mask, ref.mask)
        keys = ("size", "sampled", "voted", "undetermined", "depth",
                "outcome")
        assert [{k: e.get(k) for k in keys} for e in res.cluster_log] == \
            [{k: e.get(k) for k in keys} for e in ref.log]
    cmp = (ref.decided_at >= 0) & (ref.decided_at < f) & ref.decisive
    assert np.array_equal(res.mask[cmp], ref.mask[cmp])


def test_tf32_control_rounds_the_products():
    x = torch.randn(64, 32, dtype=torch.float64)
    c = torch.randn(4, 32, dtype=torch.float64)
    exact = csv_ref._dist2(x, c, "f64")
    low = csv_ref._dist2(x, c, "tf32")
    err = (low - exact).abs().max().item()
    assert 1e-5 < err < 1.0
