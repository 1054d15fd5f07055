"""Oracle dispatchers and per-node stats scoping on both packages.

The cases of tests/test_oracle_dispatch.py, each run on ``repro.core``
and on ``repro_torch.core`` (the ``pkg`` fixture); the last case holds
the two packages' dispatch order and scoped stats equal on one workload.
"""
import numpy as np
import pytest

from repro import core as jcore
from repro_torch import core as tcore

PKGS = {"ref": jcore, "port": tcore}


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    return PKGS[request.param]


class _ExplodingOracle:
    def __call__(self, ids):
        raise ValueError("backend down")


class _RecordingOracle:
    def __init__(self):
        self.batches = []

    def __call__(self, ids):
        ids = np.asarray(ids)
        self.batches.append(ids.copy())
        return ids % 2 == 0


@pytest.mark.parametrize("kind", ["SyncOracleDispatcher",
                                  "AsyncOracleDispatcher"])
def test_exception_propagates_through_result(pkg, kind):
    """A failing oracle must surface at .result(), not hang or vanish."""
    d = getattr(pkg, kind)(_ExplodingOracle())
    try:
        fut = d.submit(np.array([1, 2, 3]))
        with pytest.raises(ValueError, match="backend down"):
            fut.result()
    finally:
        d.close()


@pytest.mark.parametrize("kind", ["SyncOracleDispatcher",
                                  "AsyncOracleDispatcher"])
def test_close_is_idempotent(pkg, kind):
    d = getattr(pkg, kind)(_RecordingOracle())
    assert d.submit(np.array([1])).result() is not None
    d.close()
    d.close()  # second close must be a no-op, not an error


def test_async_dispatch_is_fifo(pkg):
    """Strict submission-order evaluation is the executor's bit-identity
    contract (memo + flip-stream order)."""
    oracle = _RecordingOracle()
    d = pkg.AsyncOracleDispatcher(oracle)
    try:
        batches = [np.arange(i * 10, i * 10 + 5) for i in range(6)]
        futs = [d.submit(b) for b in batches]
        for b, f in zip(batches, futs):
            assert (f.result() == (b % 2 == 0)).all()
    finally:
        d.close()
    assert [b[0] for b in oracle.batches] == [0, 10, 20, 30, 40, 50]


def test_exception_does_not_poison_later_submissions(pkg):
    ok = _RecordingOracle()

    class Flaky:
        def __init__(self):
            self.n = 0

        def __call__(self, ids):
            self.n += 1
            if self.n == 1:
                raise RuntimeError("transient")
            return ok(ids)

    d = pkg.AsyncOracleDispatcher(Flaky())
    try:
        bad = d.submit(np.array([1]))
        good = d.submit(np.array([2]))
        with pytest.raises(RuntimeError):
            bad.result()
        assert (good.result() == np.array([True])).all()
    finally:
        d.close()


def test_stats_scope_isolates_per_node_accounting(pkg):
    labels = np.zeros(100, dtype=bool)
    oracle = pkg.SyntheticOracle(labels, token_lens=np.full(100, 10))
    oracle(np.arange(10))  # prior traffic from another plan node
    with oracle.scope() as sc:
        oracle(np.arange(5, 15))  # 5 memo hits (5..9) + 5 fresh (10..14)
    assert sc.delta.n_calls == 5
    assert sc.delta.n_cached == 5
    assert sc.delta.input_tokens == 50
    assert sc.delta.batch_sizes == [5]
    assert oracle.stats.n_calls == 15


def test_stats_scope_fills_delta_on_exception(pkg):
    oracle = pkg.SyntheticOracle(np.zeros(10, dtype=bool))
    with pytest.raises(RuntimeError):
        with oracle.scope() as sc:
            oracle(np.arange(4))
            raise RuntimeError("node failed")
    assert sc.delta is not None and sc.delta.n_calls == 4


def test_dispatch_and_scoped_stats_equal_across_packages():
    """The same flipped oracle through the async lane in both packages:
    equal labels in submission order, equal scoped and lifetime stats."""
    labels = np.random.default_rng(0).random(200) < 0.4
    out = {}
    for side, p in PKGS.items():
        oracle = p.SyntheticOracle(labels, flip_prob=0.1, seed=3,
                                   token_lens=np.arange(200) % 17 + 3)
        d = p.AsyncOracleDispatcher(oracle)
        try:
            with oracle.scope() as sc:
                futs = [d.submit(np.arange(i, i + 40)) for i in (0, 20, 90)]
                res = [f.result().tolist() for f in futs]
        finally:
            d.close()
        out[side] = (res, vars(sc.delta), vars(oracle.stats))
    assert out["port"] == out["ref"]
