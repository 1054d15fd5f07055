"""The port's launchers against the reference's, on the CPU.

``repro_torch.launch.watch.main`` against ``repro.launch.watch.main``
(through a patched ``sys.argv``): a run killed after tick 3, then
resumed, prints the same lines and writes the same notification files,
and their union equals an unkilled run's.  ``serve_concurrent`` on both
packages at smoke width over one shared weight tree: pass counts, calls
and a 0-call rerun, and each package's store replayed by the other.  The
single-predicate path of ``serve.main`` against the reference's
``SemanticTable.sem_filter``: masks, calls, the printed line and a call
cache that each package reads.  ``start_metrics_server`` on an ephemeral
loopback port.

The port draws k-means++ seeds and weights from torch, the reference
from ``jax.random``; the tests inject the reference's (the seeder
through ``clustering.plusplus_init``, the weights through
``lm.params_from_jax``, the encoder's output as is).
"""
import functools
import json
import re
import shutil
import sys
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import smoke_config as jsmoke
from repro.core import clustering as jc
from repro.core import CSVConfig as JCSVConfig
from repro.core import SemanticTable as JSemanticTable
from repro.core import SyntheticOracle as JSyntheticOracle
from repro.core.oracle import ModelOracle as JModelOracle
from repro.embeddings import EmbeddingModel as JEmbeddingModel
from repro.launch import serve as jserve
from repro.launch import watch as jwatch
from repro.models import lm as jlm
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import smoke_config
from repro_torch.core import CSVConfig, SemanticTable, SyntheticOracle
from repro_torch.core import clustering as tc
from repro_torch.core.oracle import ModelOracle
from repro_torch.data import HashTokenizer, make_dataset
from repro_torch.launch import serve as tserve
from repro_torch.launch import watch as twatch
from repro_torch.models import lm
from repro_torch.obs import MetricsRegistry, StatusHub
from repro_torch.serving import ServingEngine

ARCH = "llama3.1-8b"   # serve's default --arch
_plusplus = jax.jit(jc._plusplus_init, static_argnums=2)


def jax_seeder(seed, x, k):
    return np.asarray(_plusplus(jax.random.key(seed), jnp.asarray(x), k))


@pytest.fixture(autouse=True)
def reference_seeds(monkeypatch):
    """Every k-means of the port seeds from the reference's k-means++."""
    monkeypatch.setattr(tc, "plusplus_init", jax_seeder)


@functools.lru_cache(maxsize=None)
def _tree():
    """serve's weights: the reference's init_params at jax.random.key(0)."""
    return jax.tree_util.tree_map(
        np.asarray, jlm.init_params(jsmoke(ARCH), jax.random.key(0)))


@functools.lru_cache(maxsize=None)
def _ref_embeddings(n):
    """serve's embeddings of make_dataset(n): the reference's encoder."""
    ds = make_dataset("imdb_review", n=n, seed=0)
    return JEmbeddingModel(jsmoke("e5-large"), max_len=32).encode(ds.texts)


def _engine(side, max_batch=64):
    if side == "ref":
        return JServingEngine(jsmoke(ARCH), jax.tree_util.tree_map(
            jnp.asarray, _tree()), max_batch=max_batch)
    cfg = smoke_config(ARCH)
    return ServingEngine(cfg, lm.params_from_jax(cfg, _tree(), device="cpu"),
                         max_batch=max_batch, device="cpu")


def _run_ref_main(main, argv, monkeypatch, capsys):
    """A reference CLI's ``main()`` with ``argv``; returns its stdout."""
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["prog"] + list(argv))
    main()
    return capsys.readouterr().out


def _run_port_main(main, argv, capsys):
    capsys.readouterr()
    out = main(list(argv), device="cpu")
    return capsys.readouterr().out, out


def _notify(state_dir, k=2):
    return [(state_dir / f"notify_p{i}.jsonl").read_text() for i in range(k)]


# ----------------------------------------------------------------- watch
def test_watch_kill_resume_equals_the_reference(tmp_path, monkeypatch,
                                                capsys):
    argv = ["--n", "240", "--queries", "2"]
    outs = {}
    for side in ("ref", "port"):
        d = tmp_path / side
        leg = argv + ["--state-dir", str(d)]
        if side == "ref":
            first = _run_ref_main(jwatch.main, leg + ["--kill-after", "3"],
                                  monkeypatch, capsys)
            second = _run_ref_main(jwatch.main, leg, monkeypatch, capsys)
        else:
            first, w1 = _run_port_main(twatch.main, leg + ["--kill-after",
                                                           "3"], capsys)
            second, w2 = _run_port_main(twatch.main, leg, capsys)
            assert w1.stats.n_ticks == 3 and w2.drained
        outs[side] = (first, second, _notify(d))
    assert outs["port"] == outs["ref"]
    first, second, files = outs["port"]
    assert "[watch] tick 3:" in first and "stopping mid-stream" in first
    assert "0 oracle calls to rebuild" in second
    assert "[watch] resumed done: 6 ticks, 240 rows ingested" in second

    # the kill and the resume together notify what an unkilled run does
    fresh = tmp_path / "fresh"
    out, w = _run_port_main(twatch.main, argv + ["--state-dir", str(fresh)],
                            capsys)
    assert "resumed" not in out and w.stats.n_ticks == 6
    assert files == _notify(fresh)


def test_watch_engine_empty_table_start(tmp_path, capsys):
    """``--engine``: the table starts empty, the ModelOracles read the
    table's own texts list as rows arrive, and a rerun restores."""
    argv = ["--n", "96", "--queries", "2", "--engine", "--state-dir",
            str(tmp_path), "--kill-after", "2"]
    out, w = _run_port_main(twatch.main, argv, capsys)
    assert w.stats.n_ticks == 2 and w.stats.n_rows_ingested == 80
    oracle = w.session.oracle("p0")
    assert oracle.texts is w.handle._table.texts
    assert len(oracle.texts) == 80
    out, w = _run_port_main(twatch.main, argv[:-2], capsys)
    assert "0 oracle calls to rebuild" in out and w.drained
    assert w.stats.n_rows_ingested == 96


# ----------------------------------------------------------------- serve
def _serve_lines(out):
    """The per-predicate result lines (the others carry wall times)."""
    return [ln for ln in out.splitlines() if re.match(r"\[serve\] p\d ", ln)]


def test_serve_concurrent_equals_the_reference(tmp_path, capsys):
    ds = make_dataset("imdb_review", n=48, seed=0)
    emb = _ref_embeddings(48)
    mods = {"ref": jserve, "port": tserve}
    runs = {}
    for side, mod in mods.items():
        tok = HashTokenizer(smoke_config(ARCH).vocab_size)
        lines = []
        for _ in range(2):
            capsys.readouterr()
            sess, results = mod.serve_concurrent(
                _engine(side), tok, ds, emb, 2, str(tmp_path / side))
            lines.append(_serve_lines(capsys.readouterr().out))
            masks = [r.mask for r in results]
        runs[side] = (lines, [m.tolist() for m in masks])
    assert runs["port"] == runs["ref"]
    first, rerun = runs["port"][0]
    assert all(" 0 replayed" in ln for ln in first)
    assert [ln.split(":")[1].split(";")[0] for ln in rerun] == \
        [ln.split(":")[1].split(";")[0] for ln in first]
    assert all("0 LLM calls, 48 replayed" in ln for ln in rerun)

    # each package replays the other's store at 0 calls
    for side, other in (("port", "ref"), ("ref", "port")):
        d = tmp_path / f"{side}-reads-{other}"
        shutil.copytree(tmp_path / other, d)
        capsys.readouterr()
        mods[side].serve_concurrent(
            _engine(side), HashTokenizer(smoke_config(ARCH).vocab_size),
            ds, emb, 2, str(d))
        assert _serve_lines(capsys.readouterr().out) == rerun


@pytest.mark.parametrize("method", ["csv", "csv-sim"])
def test_sem_filter_equals_the_reference_shim(method):
    """``serve.sem_filter`` (the port's stand-in for the reference's
    ``SemanticTable.sem_filter``) on a SyntheticOracle and on a
    ModelOracle over the shared weights."""
    ds = make_dataset("imdb_review", n=300, dim=16, seed=2)
    cfg = dict(n_clusters=4, min_sample=25)
    ref = JSemanticTable(texts=ds.texts, embeddings=ds.embeddings).sem_filter(
        JSyntheticOracle(ds.labels["RV-Q1"], flip_prob=0.02, seed=3),
        method=method, cfg=JCSVConfig(**cfg))
    got = tserve.sem_filter(
        SemanticTable(texts=ds.texts, embeddings=ds.embeddings,
                      device="cpu"),
        SyntheticOracle(ds.labels["RV-Q1"], flip_prob=0.02, seed=3),
        method=method, cfg=CSVConfig(**cfg))
    np.testing.assert_array_equal(got.mask, ref.mask)
    assert (got.n_llm_calls, got.oracle_batch_sizes, got.cluster_log) == \
        (ref.n_llm_calls, ref.oracle_batch_sizes, ref.cluster_log)

    small = make_dataset("imdb_review", n=64, dim=16, seed=4)
    tok = HashTokenizer(smoke_config(ARCH).vocab_size)
    jor = JModelOracle(_engine("ref"), tok, "the review is positive",
                       small.texts)
    tor = ModelOracle(_engine("port"), tok, "the review is positive",
                      small.texts)
    ref = JSemanticTable(texts=small.texts,
                         embeddings=small.embeddings).sem_filter(
        jor, method=method, cfg=JCSVConfig(**cfg))
    got = tserve.sem_filter(SemanticTable(texts=small.texts,
                                          embeddings=small.embeddings,
                                          device="cpu"),
                            tor, method=method, cfg=CSVConfig(**cfg))
    np.testing.assert_array_equal(got.mask, ref.mask)
    assert got.n_llm_calls == ref.n_llm_calls
    assert tor.memo_snapshot() == jor.memo_snapshot()
    with pytest.raises(ValueError, match="unknown method"):
        tserve.sem_filter(SemanticTable(embeddings=small.embeddings,
                                        device="cpu"), tor, method="lotus")


def test_serve_single_predicate_main_and_its_cache(tmp_path, monkeypatch,
                                                   capsys):
    """``serve.main`` without ``--service``: the same printed line and the
    same call cache as the reference's, and each package's cache makes
    the other's rerun spend 0 LLM calls."""
    monkeypatch.setattr(lm, "init_params", lambda cfg, gen, device: (
        lm.params_from_jax(cfg, _tree(), device=device)))

    class RefEncoder:
        def __init__(self, cfg, max_len, device):
            assert cfg.name == smoke_config("e5-large").name
            assert max_len == 32

        def encode(self, texts):
            return _ref_embeddings(len(texts))

    monkeypatch.setattr(tserve, "EmbeddingModel", RefEncoder)
    common = ["--n", "48", "--vote", "csv-sim"]
    caches = {s: tmp_path / f"{s}.json" for s in ("ref", "port")}
    ref_out = _run_ref_main(jserve.main, common + ["--cache",
                                                   str(caches["ref"])],
                            monkeypatch, capsys)
    port_out, (_, oracle, r) = _run_port_main(
        tserve.main, common + ["--cache", str(caches["port"])], capsys)
    assert port_out == ref_out
    assert json.loads(caches["port"].read_text()) == \
        json.loads(caches["ref"].read_text())
    assert r.n_llm_calls == len(oracle.memo_snapshot()) > 0

    for side, other in (("port", "ref"), ("ref", "port")):
        cache = tmp_path / f"{side}-reads-{other}.json"
        shutil.copy(caches[other], cache)
        argv = common + ["--cache", str(cache)]
        out = (_run_port_main(tserve.main, argv, capsys)[0] if side == "port"
               else _run_ref_main(jserve.main, argv, monkeypatch, capsys))
        assert f"restored {r.n_llm_calls} cached calls" in out
        assert f"{int(r.mask.sum())}/48 pass; 0 LLM calls" in out


def test_start_metrics_server_on_loopback():
    reg = MetricsRegistry()
    reg.counter("stream.ticks").inc(3)
    hub = StatusHub()
    hub.add_provider("stream", lambda: {"tick": 3})
    srv = tserve.start_metrics_server(reg, 0, hub=hub, label="watch")
    host, port = srv.server_address[:2]
    assert host == "127.0.0.1"
    try:
        with urllib.request.urlopen(f"http://{host}:{port}/metrics",
                                    timeout=5) as resp:
            assert "stream_ticks 3" in resp.read().decode()
        with urllib.request.urlopen(f"http://{host}:{port}/statusz",
                                    timeout=5) as resp:
            assert json.loads(resp.read())["stream"] == {"tick": 3}
    finally:
        srv.shutdown()
        srv.server_close()


def test_launchers_refuse_cuda_without_a_card(monkeypatch, tmp_path):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (twatch.main, tserve.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--state-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())
