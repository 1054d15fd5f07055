"""The stream layer on the card (``cuda``-marked: skips without a GPU).

A watcher's ticks launch K1 (the nearest-centroid patch of each tick's
rows, and the first tick's k-means) and K3 (the re-votes under SimVote)
from the scheduler's query threads, on the default stream where their
inputs were made, and notify what the same stream notifies on the CPU.
K1 and K3 at the shapes a stream tick gives them match their plain
versions within tests/test_torch_kernels.py's tolerances.  No JAX here:
this file runs where the card is.
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.api import ExecutionPolicy, Session
from repro_torch.core.oracle import SyntheticOracle
from repro_torch.data import make_dataset
from repro_torch.kernels import build
from repro_torch.kernels.kmeans.kernel import assign_clusters_cuda
from repro_torch.kernels.kmeans.ref import assign_clusters_ref
from repro_torch.kernels.simvote.kernel import simvote_scores_segmented_cuda
from repro_torch.kernels.simvote.ref import simvote_scores_segmented_ref
from repro_torch.stream import (CallbackSink, RateBudget, StreamWatcher,
                                SyntheticSource)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _run_stream(device, ds):
    sess = Session(policy=ExecutionPolicy(n_clusters=4, xi=0.005,
                                          method="csv-sim"), device=device)
    for i, (key, seed) in enumerate((("RV-Q1", 7), ("RV-Q3", 8))):
        sess.register_oracle(f"p{i}", SyntheticOracle(
            ds.labels[key], flip_prob=0.0, seed=seed,
            token_lens=ds.token_lens))
    w = StreamWatcher(sess, table_name="feed")
    w.add_source(SyntheticSource("s0", texts=list(ds.texts),
                                 embeddings=ds.embeddings,
                                 arrive_per_tick=250, seed=3),
                 RateBudget(rows_per_tick=250))
    events = []
    for name in ("p0", "p1"):
        w.register(name, sink=CallbackSink(events.append))
    try:
        return w.run(), [(e["query"], e["tick"], e["row"]) for e in events]
    finally:
        sess.close()


@pytest.mark.cuda
def test_cuda_stream_ticks_launch_on_the_default_stream(cuda):
    ds = make_dataset("imdb_review", n=2000, dim=256, seed=0)
    seen = []
    real = build.stream_ptr

    def spy(device):
        seen.append((threading.current_thread().name, real(device)))
        return real(device)

    for fn in (assign_clusters_cuda, simvote_scores_segmented_cuda):
        fn.launches = 0
    build.stream_ptr = spy
    try:
        ticks, events = _run_stream("cuda", ds)
    finally:
        build.stream_ptr = real
    assert assign_clusters_cuda.launches > 0
    assert simvote_scores_segmented_cuda.launches > 0
    default = torch.cuda.default_stream(cuda).cuda_stream
    assert any(name.startswith("csv-service-") for name, _ in seen)
    assert all(ptr == default for _, ptr in seen)
    # the same stream on the CPU, through the plain versions
    assert (ticks, events) == _run_stream("cpu", ds)
    assert sum(t["rows"] for t in ticks) == 2000


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(2500, 1024), (250, 256), (60, 64), (0, 1024)])
def test_cuda_k1_at_a_tick_patch_matches_plain(cuda, n, d):
    """A tick's rows against the table's four frozen centroids."""
    rng = np.random.default_rng(n + d)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(cuda)
    c = torch.from_numpy(rng.normal(size=(4, d)).astype(np.float32)).to(cuda)
    before = assign_clusters_cuda.launches
    a1, d1 = assign_clusters_cuda(x, c)
    a2, d2 = assign_clusters_ref(x, c)
    torch.cuda.synchronize()
    assert a1.shape == (n,) and d1.shape == (n,)
    if n:
        assert (a1 == a2).float().mean().item() >= 0.999
    torch.testing.assert_close(d1, d2, rtol=1e-5, atol=1e-5)
    # no rows, no launch
    assert assign_clusters_cuda.launches == before + (1 if n else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("counts,m,d", [
    ([600, 0, 580, 610], 101, 1024),   # a tick's dirty clusters, E5 width
    ([40, 35, 0, 52], 25, 256),
    ([2400, 2350, 2500, 2410], 101, 1024)])
def test_cuda_k3_at_a_tick_revote_matches_plain(cuda, counts, m, d):
    rng = np.random.default_rng(sum(counts) + m + d)
    c = len(counts)
    x = rng.normal(size=(sum(counts), d)).astype(np.float32)
    s_pad = rng.normal(size=(c, m, d)).astype(np.float32)
    y_pad = (rng.random((c, m)) > 0.5).astype(np.float32)
    y_pad[0, m // 2:] = -1.0          # a cluster with fewer samples
    taus = np.sqrt(d) * (1.0 + rng.random(c))
    args = (torch.from_numpy(x).to(cuda), np.array(counts),
            torch.from_numpy(s_pad).to(cuda),
            torch.from_numpy(y_pad).to(cuda), taus)
    torch.testing.assert_close(simvote_scores_segmented_cuda(*args),
                               simvote_scores_segmented_ref(*args),
                               rtol=1e-5, atol=1e-6)
