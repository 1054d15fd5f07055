"""The port's sharded CSV rounds and distributed k-means step against the
JAX reference.

Same table, same oracle seeds, the reference's k-means++ injected through
the port's seeder hook: at any shard count the port's masks, call counts,
``cluster_log``, ``round_log`` (shards and per-shard batches included) and
oracle memo equal the reference's, and equal the port's own ``shards=1``
run.  ``distributed_kmeans_step`` on a ``torch.distributed`` gloo group is
held against the reference's step under ``shard_map``.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from repro.api import ExecutionPolicy as JPolicy
from repro.api import Session as JSession
from repro.core import clustering as jc
from repro.core import csv_filter as jcf
from repro.core.oracle import SyntheticOracle as JSyntheticOracle
from repro.data import make_dataset
from repro.distributed import shard_clusters as j_shard_clusters
from repro_torch.api import ExecutionPolicy, Session
from repro_torch.core import clustering as tc
from repro_torch.core import csv_filter as tcf
from repro_torch.core.oracle import SyntheticOracle
from repro_torch.distributed import shard_clusters

ROOT = Path(__file__).resolve().parents[1]
N = 3000
_plusplus = jax.jit(jc._plusplus_init, static_argnums=2)


def jax_seeder(seed, x, k):
    """The reference's k-means++ for ``jax.random.key(seed)``."""
    return np.asarray(_plusplus(jax.random.key(seed), jnp.asarray(x), k))


@pytest.fixture(scope="module")
def ds():
    return make_dataset("imdb_review", n=N, seed=0)


def _oracle(cls, ds, query="RV-Q1"):
    return cls(ds.labels[query], flip_prob=0.02, seed=7,
               token_lens=ds.token_lens)


def _port_run(ds, shards, vote):
    oracle = _oracle(SyntheticOracle, ds)
    res = tcf.semantic_filter(
        ds.embeddings, oracle,
        tcf.CSVConfig(n_clusters=4, xi=0.005, vote=vote, shards=shards),
        init_centroids=jax_seeder, device="cpu")
    return res, oracle


def assert_same_run(got, ref):
    np.testing.assert_array_equal(got.mask, ref.mask)
    for field in ("n_llm_calls", "input_tokens", "output_tokens", "n_voted",
                  "n_fallback", "recluster_rounds", "cluster_log", "xi_used",
                  "oracle_batch_sizes", "n_input"):
        assert getattr(got, field) == getattr(ref, field), field
    assert ([dataclasses.asdict(r) for r in got.round_log]
            == [dataclasses.asdict(r) for r in ref.round_log])


# ------------------------------------------------------------ bit-identity
@pytest.mark.parametrize("vote", ["uni", "sim"])
@pytest.mark.parametrize("shards", [2, 3, 5])
def test_sharded_round_matches_reference(ds, vote, shards):
    ref_oracle = _oracle(JSyntheticOracle, ds)
    ref = jcf.semantic_filter(
        ds.embeddings, ref_oracle,
        jcf.CSVConfig(n_clusters=4, xi=0.005, vote=vote, shards=shards))
    got, oracle = _port_run(ds, shards, vote)
    assert_same_run(got, ref)
    assert oracle.memo_snapshot() == ref_oracle.memo_snapshot()
    assert any(rr.shards > 1 for rr in got.round_log)
    # and the port's own shards=1 run: equal but for the batch split
    one, one_oracle = _port_run(ds, 1, vote)
    np.testing.assert_array_equal(got.mask, one.mask)
    assert got.n_llm_calls == one.n_llm_calls
    assert got.cluster_log == one.cluster_log
    assert (got.n_voted, got.n_fallback, got.recluster_rounds) == (
        one.n_voted, one.n_fallback, one.recluster_rounds)
    assert oracle.memo_snapshot() == one_oracle.memo_snapshot()
    for rr1, rrs in zip(one.round_log, got.round_log):
        assert 1 <= rrs.shards <= shards
        assert sum(rrs.oracle_batches) == sum(rr1.oracle_batches)


def test_sharded_round_through_policy_matches_reference(ds):
    """ExecutionPolicy(shards=3) flows through Session.collect()."""
    def collect(session_cls, policy_cls, oracle_cls, shards, **kw):
        sess = session_cls(policy=policy_cls(n_clusters=4, xi=0.005,
                                             shards=shards), **kw)
        t = sess.table(embeddings=ds.embeddings, name="reviews")
        return t.filter(_oracle(oracle_cls, ds), name="q").collect()

    ref = collect(JSession, JPolicy, JSyntheticOracle, 3)
    got = collect(Session, ExecutionPolicy, SyntheticOracle, 3,
                  device="cpu", init_centroids=jax_seeder)
    one = collect(Session, ExecutionPolicy, SyntheticOracle, 1,
                  device="cpu", init_centroids=jax_seeder)
    np.testing.assert_array_equal(got.mask, ref.mask)
    assert got.n_llm_calls == ref.n_llm_calls
    assert ({k: [dataclasses.asdict(r) for r in v]
             for k, v in got.round_log.items()}
            == {k: [dataclasses.asdict(r) for r in v]
                for k, v in ref.round_log.items()})
    np.testing.assert_array_equal(got.mask, one.mask)
    assert got.n_llm_calls == one.n_llm_calls


def test_shards_validation():
    with pytest.raises(ValueError, match="shards"):
        ExecutionPolicy(shards=0)
    with pytest.raises(ValueError, match="executor"):
        ExecutionPolicy(shards=2, executor="sequential")
    with pytest.raises(ValueError, match="executor"):
        tcf.semantic_filter(np.zeros((4, 2), np.float32),
                            SyntheticOracle(np.zeros(4, bool)),
                            tcf.CSVConfig(shards=2, executor="sequential"),
                            device="cpu")
    with pytest.raises(ValueError, match="shards"):
        tcf.semantic_filter(np.zeros((4, 2), np.float32),
                            SyntheticOracle(np.zeros(4, bool)),
                            tcf.CSVConfig(shards=0), device="cpu")


@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
def test_shard_clusters_matches_reference(n_shards):
    @dataclasses.dataclass
    class _CP:
        n_sample: int

    for sizes in ((5, 5, 5, 50, 5, 5, 5, 5, 50, 5), (101, 7), (3,)):
        clusters = [_CP(n) for n in sizes]
        got = shard_clusters(clusters, n_shards)
        want = j_shard_clusters(clusters, n_shards)
        assert ([[cp.n_sample for cp in s] for s in got]
                == [[cp.n_sample for cp in s] for s in want])
        # a contiguous, complete, order-preserving partition
        assert [cp for s in got for cp in s] == clusters
        assert 1 <= len(got) <= max(1, min(n_shards, len(clusters)))


# ------------------------------------------------- distributed k-means
_RANK = textwrap.dedent("""
    import datetime, sys
    import numpy as np, torch, torch.distributed as dist
    from repro_torch.core.clustering import distributed_kmeans_step
    store_path, rank, world, data, out = sys.argv[1:]
    rank, world = int(rank), int(world)
    d = np.load(data)
    rows = np.array_split(d["x"], world)[rank]
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        cents = distributed_kmeans_step(torch.from_numpy(rows),
                                        torch.from_numpy(d["c"]))
        np.save(out, cents.numpy())
    finally:
        dist.destroy_process_group()
""")


def _gloo_step(x, c, world, tmp_path):
    """distributed_kmeans_step over ``world`` gloo ranks in their own
    processes, each with its contiguous share of the rows (the layout
    ``shard_map`` gives ``P("data")``); returns every rank's centroids."""
    data = tmp_path / f"data{world}.npz"
    np.savez(data, x=x, c=c)
    store = tmp_path / f"store{world}"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    outs = [tmp_path / f"w{world}_r{r}.npy" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(store), str(r), str(world),
         str(data), str(outs[r])], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [np.load(o) for o in outs]


def test_distributed_kmeans_step_matches_reference(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(800, 16)).astype(np.float32)
    c = x[rng.choice(800, 4, replace=False)] + 0.1
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    step = jax.shard_map(partial(jc.distributed_kmeans_step,
                                 mesh_axis="data"),
                         mesh=mesh, in_specs=(P("data"), P(None, None)),
                         out_specs=P(None, None))
    want = np.asarray(step(jnp.asarray(x), jnp.asarray(c)))
    (one,) = _gloo_step(x, c, 1, tmp_path)
    np.testing.assert_allclose(one, want, rtol=0, atol=1e-5)
    two = _gloo_step(x, c, 2, tmp_path)
    np.testing.assert_array_equal(two[0], two[1])  # replicated
    np.testing.assert_allclose(two[0], one, rtol=0, atol=1e-5)
    # one Lloyd step from the port's own assignment, for the CPU path
    a = tc.kmeans_predict(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    lloyd = np.stack([x[a == i].mean(0) if (a == i).any() else c[i]
                      for i in range(4)])
    np.testing.assert_allclose(one, lloyd, rtol=0, atol=1e-5)


def test_distributed_kmeans_step_sums_in_f64(tmp_path):
    """20,000 rows near 100 in one cluster: f32 sums of them drift far past
    1e-5 of the mean; the step's centroid is the f64 mean within 1e-5."""
    rng = np.random.default_rng(1)
    x = (100.0 + rng.normal(size=(20000, 8))).astype(np.float32)
    c = np.stack([x[0], x[0] + 1e4]).astype(np.float32)
    (got,) = _gloo_step(x, c, 1, tmp_path)
    want = x.astype(np.float64).mean(0)
    np.testing.assert_allclose(got[0], want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[1], c[1])  # an empty cluster stays


def test_distributed_kmeans_step_needs_a_process_group():
    x = torch.zeros((8, 4))
    with pytest.raises(RuntimeError, match="process group"):
        tc.distributed_kmeans_step(x, x[:2])
