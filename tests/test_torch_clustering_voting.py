"""Clustering, voting and the copied host modules of the PyTorch port
against the JAX reference, on the CPU.

k-means is seeded through the port's seeder hook with the reference's own
k-means++ (``repro.core.clustering._plusplus_init``, jitted with k static
as ``kmeans`` runs it), so both Lloyd loops start from the same centroids.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clustering as jc
from repro.core import theory as jtheory
from repro.core import voting as jv
from repro.data.synthetic import make_dataset as jmake_dataset
from repro.data.tokenizer import HashTokenizer as JHashTokenizer
from repro_torch.core import clustering as tc
from repro_torch.core import theory as ttheory
from repro_torch.core import voting as tv
from repro_torch.data.synthetic import make_dataset as tmake_dataset
from repro_torch.data.tokenizer import HashTokenizer as THashTokenizer

_plusplus = jax.jit(jc._plusplus_init, static_argnums=2)


def jax_seeder(seed, x, k):
    """The reference's k-means++ for ``jax.random.key(seed)``."""
    return np.asarray(_plusplus(jax.random.key(seed), jnp.asarray(x), k))


def _blobs(seed, n, d, centers):
    rng = np.random.default_rng(seed)
    c = rng.normal(0, 3.0, (centers, d))
    return (c[rng.integers(0, centers, n)]
            + rng.normal(0, 1.0, (n, d))).astype(np.float32)


# ------------------------------------------------------------- k-means
@pytest.mark.parametrize("seed,n,d,k", [(0, 300, 8, 4), (1, 517, 16, 6),
                                        (2, 1000, 32, 3), (3, 64, 4, 8)])
def test_kmeans_matches_reference_with_injected_seeds(seed, n, d, k):
    x = _blobs(seed, n, d, centers=k + 1)
    c_j, a_j, i_j = jc.kmeans(jax.random.key(seed), jnp.asarray(x), k)
    c_t, a_t, i_t = tc.kmeans(seed, x, k, init_centroids=jax_seeder,
                              device="cpu")
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(i_t), float(i_j), rtol=1e-5)


def test_kmeans_reseeds_empty_clusters_like_reference():
    """Duplicate seeds leave a cluster empty: both re-seed it the same way."""
    x = _blobs(7, 200, 4, centers=3)

    def dup_seeder(seed, xx, k):
        return np.repeat(np.asarray(xx)[:1], k, axis=0)

    cents0 = jnp.asarray(dup_seeder(0, x, 3))
    # the reference Lloyd loop from the same start, without its seeding
    orig = jc._plusplus_init
    try:
        jc._plusplus_init = lambda key, xx, k: cents0
        c_j, a_j, _ = jc.kmeans.__wrapped__(jax.random.key(0),
                                            jnp.asarray(x), 3)
    finally:
        jc._plusplus_init = orig
    c_t, a_t, _ = tc.kmeans(0, x, 3, init_centroids=dup_seeder, device="cpu")
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-5,
                               atol=1e-5)


def test_default_seeder_is_deterministic_and_kmeans_plus_plus():
    x = _blobs(4, 400, 8, centers=4)
    c1 = tc.plusplus_init(11, x, 4)
    c2 = tc.plusplus_init(11, x, 4)
    np.testing.assert_array_equal(c1, c2)
    # every seed is a data point, and k-means++ picks distinct ones here
    assert all((x == c).all(axis=1).any() for c in c1)
    assert len({tuple(c) for c in c1}) == 4
    _, a, inertia = tc.kmeans(11, x, 4, device="cpu")
    assert a.shape == (400,) and a.dtype == torch.int32
    assert float(inertia) > 0


def test_kmeans_predict_and_assign_to_nearest_match_reference():
    x = _blobs(5, 257, 16, centers=5)
    cents = x[:5]
    np.testing.assert_array_equal(
        tc.assign_to_nearest(x, cents, device="cpu"),
        jc.assign_to_nearest(x, cents))
    np.testing.assert_array_equal(
        tc.kmeans_predict(torch.from_numpy(x), torch.from_numpy(cents)).numpy(),
        np.asarray(jc.kmeans_predict(jnp.asarray(x), jnp.asarray(cents))))


def test_minibatch_kmeans_update_matches_reference():
    x = _blobs(6, 128, 8, centers=4)
    cents, counts = x[:4].copy(), np.arange(1, 5, dtype=np.float32)
    c_j, n_j = jc.minibatch_kmeans_update(jnp.asarray(cents),
                                          jnp.asarray(counts),
                                          jnp.asarray(x[4:]))
    c_t, n_t = tc.minibatch_kmeans_update(torch.from_numpy(cents),
                                          torch.from_numpy(counts),
                                          torch.from_numpy(x[4:]))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))


def test_kmeans_without_cuda_raises_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.kmeans(0, _blobs(0, 20, 2, 2), 2)


# -------------------------------------------------------------- voting
SEEDS = list(range(10))


def _ragged_clusters(rng, d=None):
    c = int(rng.integers(1, 8))
    d = d or int(rng.integers(2, 24))
    xs, ss, ys = [], [], []
    for _ in range(c):
        n_c = int(rng.integers(0, 90))  # 0 => exhausted cluster
        m_c = int(rng.integers(0, 40))  # 0 => no evidence
        xs.append(rng.normal(size=(n_c, d)).astype(np.float32))
        ss.append(rng.normal(size=(m_c, d)).astype(np.float32))
        ys.append((rng.random(m_c) < rng.random()).astype(np.float32))
    return xs, ss, ys


def _same_partition(a, b):
    assert (a.decided_true == b.decided_true).all()
    assert (a.decided_false == b.decided_false).all()
    assert (a.undetermined == b.undetermined).all()
    assert len(a.scores) == len(b.scores)


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_sim_vote_batch_matches_reference_on_ragged_rounds(seed):
    rng = np.random.default_rng(seed)
    xs, ss, ys = _ragged_clusters(rng)
    lb = float(rng.uniform(0.1, 0.45))
    ub = float(rng.uniform(lb + 0.05, 0.95))
    bw = None if seed % 2 else float(rng.uniform(0.5, 3.0))
    ref = jv.sim_vote_batch(xs, ss, ys, lb, ub, bw)
    got = tv.sim_vote_batch(xs, ss, ys, lb, ub, bw, device="cpu")
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        _same_partition(a, b)
        np.testing.assert_allclose(a.scores, b.scores, rtol=1e-5, atol=1e-6)
    # per-cluster entry point, and the round entry point the driver calls
    for x, s, y, b in zip(xs, ss, ys, ref):
        _same_partition(tv.sim_vote(x, s, y, lb, ub, bw, device="cpu"), b)
    via = tv.vote_clusters("sim", ys, [len(x) for x in xs], lb, ub,
                           emb_unsampled=xs, emb_sampled=ss, bandwidth=bw,
                           device="cpu")
    for a, b in zip(via, ref):
        _same_partition(a, b)


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_uni_vote_batch_matches_reference(seed):
    rng = np.random.default_rng(seed)
    c = int(rng.integers(1, 10))
    labels = [(rng.random(int(rng.integers(0, 60))) < rng.random()
               ).astype(np.float32) for _ in range(c)]
    nuns = [int(rng.integers(0, 50)) for _ in range(c)]
    lb = float(rng.uniform(0.05, 0.45))
    ub = float(rng.uniform(lb + 0.05, 0.99))
    for a, b in zip(tv.vote_clusters("uni", labels, nuns, lb, ub),
                    jv.vote_clusters("uni", labels, nuns, lb, ub)):
        _same_partition(a, b)


def test_vote_edge_cases_match_reference():
    """Empty sample -> undetermined; no unsampled rows -> empty results."""
    x = np.random.default_rng(0).normal(size=(5, 8)).astype(np.float32)
    empty_s = np.zeros((0, 8), np.float32)
    for a, b in ((tv.sim_vote(x, empty_s, np.zeros(0), 0.15, 0.85,
                              device="cpu"),
                  jv.sim_vote(x, empty_s, np.zeros(0), 0.15, 0.85)),
                 (tv.sim_vote(x[:0], x, np.ones(5), 0.15, 0.85, device="cpu"),
                  jv.sim_vote(x[:0], x, np.ones(5), 0.15, 0.85)),
                 (tv.uni_vote(np.zeros(0), 7, 0.15, 0.85),
                  jv.uni_vote(np.zeros(0), 7, 0.15, 0.85))):
        _same_partition(a, b)
    got = tv.sim_vote_batch([x, x, x[:0]], [empty_s, x[:2], x[:2]],
                            [np.zeros(0), np.ones(2, np.float32),
                             np.ones(2, np.float32)], 0.15, 0.85,
                            device="cpu")
    assert len(got[0].undetermined) == 5 and len(got[1].decided_true) == 5
    assert len(got[2].scores) == 0
    assert tv.default_bandwidth(x) == jv.default_bandwidth(x)
    with pytest.raises(ValueError, match="vote kind"):
        tv.vote_clusters("majority", [], [], 0.1, 0.9)


# ------------------------------------------- copied numpy/python modules
@pytest.mark.parametrize("name", ["imdb_review", "codebase", "airdialogue"])
def test_make_dataset_is_byte_identical(name):
    a = jmake_dataset(name, n=500, dim=24, seed=3)
    b = tmake_dataset(name, n=500, dim=24, seed=3)
    assert a.embeddings.tobytes() == b.embeddings.tobytes()
    assert a.texts == b.texts
    assert a.labels.keys() == b.labels.keys()
    for q in a.labels:
        assert a.labels[q].tobytes() == b.labels[q].tobytes()
    assert a.token_lens.tobytes() == b.token_lens.tobytes()
    assert a.topics.tobytes() == b.topics.tobytes()


def test_hash_tokenizer_gives_the_same_ids():
    ds = tmake_dataset("imdb_review", n=50, dim=8)
    for vocab in (512, 128256):
        j, t = JHashTokenizer(vocab), THashTokenizer(vocab)
        for text in ds.texts + ["Answer yes or no: does it? answer: no"]:
            assert j.encode(text) == t.encode(text)


def test_theory_functions_are_equal():
    for eps in (0.01, 0.05, 0.2):
        for s2 in (0.05, 0.25):
            assert (ttheory.xi_for_epsilon_univote(eps, s2)
                    == jtheory.xi_for_epsilon_univote(eps, s2))
            assert (ttheory.xi_for_epsilon_simvote(eps, s2)
                    == jtheory.xi_for_epsilon_simvote(eps, s2))
            for weighted in (False, True):
                assert (ttheory.epsilon_for_xi(0.1, 1000, s2,
                                               weighted=weighted)
                        == jtheory.epsilon_for_xi(0.1, 1000, s2,
                                                  weighted=weighted))
    assert ttheory.bernstein_tail(50, 1000, 0.1, 0.25) == \
        jtheory.bernstein_tail(50, 1000, 0.1, 0.25)
    assert [ttheory.choose_sample_size(n, 0.005) for n in (10, 500, 50000)] \
        == [jtheory.choose_sample_size(n, 0.005) for n in (10, 500, 50000)]
    assert dataclasses.is_dataclass(tv.VoteResult)
