"""The port's fused one-engine serving path against the JAX reference.

The packing and pipelining cases of tests/test_fused_serving.py on the
port: ``evaluate_packed`` against per-oracle dispatch (labels, memo,
stats and the raw yes/no logits, exactly), duplicate-oracle deferral and
inline synthetic oracles, the multi-oracle service making one engine
invocation per (tick, bucket) with masks and calls equal to serial
collects, service-level pipelining, and truncation counters.  Each also
holds the port against the reference on the same inputs: the model
oracles run the reference's ``init_params`` tree carried across by
``lm.params_from_jax``, so masks, call counts, ``oracle_batch_sizes``
and engine statistics compare exactly.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import api as japi
from repro.configs import smoke_config as jsmoke
from repro.core import clustering as jc
from repro.core import oracle as joracle
from repro.models import lm as jlm
from repro.serving import ServingEngine as JServingEngine
from repro.serving.batcher import DispatchMergeStats as JDispatchMergeStats
from repro_torch import api as tapi
from repro_torch.configs import smoke_config
from repro_torch.core import oracle as toracle
from repro_torch.data import make_dataset
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.models import lm
from repro_torch.serving import BucketBatcher, ServingEngine
from repro_torch.serving.batcher import DispatchMergeStats

ARCH = "qwen1.5-0.5b"
_plusplus = jax.jit(jc._plusplus_init, static_argnums=2)


def jax_seeder(seed, x, k):
    return np.asarray(_plusplus(jax.random.key(seed), jnp.asarray(x), k))


@functools.lru_cache(maxsize=None)
def _tree():
    return jax.tree_util.tree_map(
        np.asarray, jlm.init_params(jsmoke(ARCH), jax.random.key(0)))


def _engine(side, max_batch):
    if side == "ref":
        params = jax.tree_util.tree_map(jnp.asarray, _tree())
        return JServingEngine(jsmoke(ARCH), params, max_batch=max_batch)
    cfg = smoke_config(ARCH)
    return ServingEngine(cfg, lm.params_from_jax(cfg, _tree(), device="cpu"),
                         max_batch=max_batch, device="cpu")


ORACLE = {"ref": joracle, "port": toracle}
API = {"ref": japi, "port": tapi}
PREDS = ("the text is positive", "the text mentions acting",
         "the text discusses plot")


def _mk_oracles(side, engine, texts):
    tok = HashTokenizer(engine.cfg.vocab_size)
    return [ORACLE[side].ModelOracle(engine, tok, pred, texts)
            for pred in PREDS]


def _both(fn):
    out = {side: fn(side) for side in ("ref", "port")}
    assert _plain(out["port"]) == _plain(out["ref"])
    return out["port"]


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.integer, np.bool_)):
        return x.item()
    return x


def _merge_counts(m):
    """A DispatchMergeStats' counters (its wall times are the host's)."""
    return (m.n_invocations, m.n_requests, m.total_ids, m.total_tokens,
            m.n_truncated)


# --------------------------------------------------------- packed waves
def test_packed_wave_bit_identity():
    """evaluate_packed == per-oracle dispatch: labels, memo, stats, and
    the packed pair logits equal the per-oracle ones exactly."""
    texts = [f"sample review {i} with a few extra words of padding "
             f"{'great' if i % 2 else 'awful'}" for i in range(10)]
    ids = np.arange(10)

    def run(side):
        e_solo = _engine(side, 32)
        solo = _mk_oracles(side, e_solo, texts)
        ctrl = [o(ids) for o in solo]
        e_pack = _engine(side, 32)
        packed = _mk_oracles(side, e_pack, texts)
        outs, info = ORACLE[side].evaluate_packed([(o, ids) for o in packed])
        for a, b in zip(ctrl, outs):
            assert np.array_equal(a, b)
        for a, b in zip(solo, packed):
            assert a.stats.n_calls == b.stats.n_calls
            assert a.stats.batch_sizes == b.stats.batch_sizes
            assert a.memo_snapshot() == b.memo_snapshot()
        assert info["tokens"] > 0
        assert e_pack.stats["batches"] < e_solo.stats["batches"]
        assert e_pack.mean_batch_size > e_solo.mean_batch_size
        p_all = [p for o in packed for p in o.pack_prompts(ids)]
        t_all = np.concatenate([o.pack_token_ids(len(ids)) for o in packed])
        wave = _engine(side, 32).first_token_logits(p_all, token_ids=t_all)
        per = np.concatenate([
            _engine(side, 32).first_token_logits(
                o.pack_prompts(ids), token_ids=o.pack_token_ids(len(ids)))
            for o in packed])
        assert np.array_equal(wave, per)
        return (outs, info, e_pack.stats, e_solo.stats,
                [o.stats.batch_sizes for o in packed])
    _both(run)


def test_packed_wave_duplicate_oracle_and_synthetic():
    labels = np.arange(20) % 2 == 0

    def run(side):
        Oracle = ORACLE[side].SyntheticOracle
        o1 = Oracle(labels, flip_prob=0.0)
        o2 = Oracle(~labels, flip_prob=0.0)
        reqs = [(o1, np.arange(5)), (o2, np.arange(10)),
                (o1, np.arange(3, 8))]
        outs, info = ORACLE[side].evaluate_packed(reqs)
        assert np.array_equal(outs[0], labels[:5])
        assert np.array_equal(outs[1], ~labels[:10])
        assert np.array_equal(outs[2], labels[3:8])
        assert o1.stats.n_cached == 2   # the second o1 request hit the memo
        assert info["tokens"] > 0
        return outs, info, o1.stats.batch_sizes, o2.stats.batch_sizes
    _both(run)


# ------------------------------------------------- service-level assertions
def _model_workload(side, ds, max_batch=64):
    engine = _engine(side, max_batch)
    pol = API[side].ExecutionPolicy(n_clusters=2, min_sample=8, pilot_size=6)
    if side == "ref":
        sess = japi.Session(policy=pol)
    else:
        sess = tapi.Session(policy=pol, init_centroids=jax_seeder,
                            device="cpu")
    handle = sess.table(embeddings=ds.embeddings, name="reviews")
    oracles = _mk_oracles(side, engine, ds.texts)
    qs = [handle.filter(o, name=f"p{i}") for i, o in enumerate(oracles)]
    return sess, qs, oracles, engine


def test_multi_oracle_service_one_invocation_per_tick():
    """One engine invocation per (tick, length bucket) across all oracles
    sharing the engine; masks and calls equal serial collects; packing at
    least doubles the prompts an engine call (against ``pack=False``)."""
    ds = make_dataset("imdb_review", n=36, seed=0)

    def run(side):
        sess_s, qs_s, oracles_s, _ = _model_workload(side, ds)
        serial = [q.collect() for q in qs_s]
        sess_c, qs_c, oracles_c, engine = _model_workload(side, ds)
        with sess_c.scheduler.holding():
            tickets = [sess_c.submit(q) for q in qs_c]
        conc = sess_c.gather(*tickets)
        merge = sess_c.scheduler.stats.merge
        for rs, rc in zip(serial, conc):
            assert (rc.mask == rs.mask).all()
            assert rc.n_llm_calls == rs.n_llm_calls
        for a, b in zip(oracles_s, oracles_c):
            assert a.stats.n_calls == b.stats.n_calls
            assert a.stats.batch_sizes == b.stats.batch_sizes
        assert merge.n_invocations <= engine.stats["batches"]
        assert engine.stats["batches"] <= 2 * merge.n_invocations
        assert merge.total_wall_s > 0 and merge.total_tokens > 0
        sess_c.close()

        sess_u, qs_u, _, engine_u = _model_workload(side, ds)
        sess_u.scheduler.pack = False
        with sess_u.scheduler.holding():
            tickets = [sess_u.submit(q) for q in qs_u]
        unpacked = sess_u.gather(*tickets)
        for rs, ru in zip(serial, unpacked):
            assert (ru.mask == rs.mask).all()
            assert ru.n_llm_calls == rs.n_llm_calls
        assert engine.mean_batch_size >= 2 * engine_u.mean_batch_size
        sess_u.close()
        return ([(r.mask, r.n_llm_calls) for r in conc],
                [o.stats.batch_sizes for o in oracles_c],
                _merge_counts(merge), engine.stats, engine_u.stats)
    _both(run)


def test_pipelined_tick_bit_identity():
    ds = make_dataset("imdb_review", n=400, seed=0)

    def run(side, depth):
        pol = API[side].ExecutionPolicy(n_clusters=4, xi=0.005,
                                        pipeline_depth=depth)
        if side == "ref":
            sess = japi.Session(policy=pol)
        else:
            sess = tapi.Session(policy=pol, init_centroids=jax_seeder,
                                device="cpu")
        handle = sess.table(embeddings=ds.embeddings, name="reviews")
        oracles = [ORACLE[side].SyntheticOracle(
            ds.labels[k], flip_prob=0.02, seed=s, token_lens=ds.token_lens)
            for k, s in (("RV-Q1", 7), ("RV-Q2", 8), ("RV-Q3", 9))]
        qs = [handle.filter(o, name=f"p{i}") for i, o in enumerate(oracles)]
        assert sess.scheduler.pipeline_depth == depth
        with sess.scheduler.holding():
            tickets = [sess.submit(q) for q in qs]
        res = sess.gather(*tickets)
        stats = sess.scheduler.stats
        sess.close()
        return res, stats, [o.stats.batch_sizes for o in oracles]

    def side_run(side):
        r1, s1, b1 = run(side, 1)
        r2, s2, b2 = run(side, 2)
        for a, b in zip(r1, r2):
            assert (a.mask == b.mask).all()
            assert a.n_llm_calls == b.n_llm_calls
        assert s1.merge.total_ids == s2.merge.total_ids
        assert s2.merge.n_invocations >= s1.merge.n_invocations
        return ([(r.mask, r.n_llm_calls) for r in r1], b1, b2,
                _merge_counts(s1.merge), _merge_counts(s2.merge))
    _both(side_run)


# ----------------------------------------------------- truncation visibility
def test_truncation_stats_surface():
    b = BucketBatcher(max_batch=4, max_bucket=32)
    b.plan([[1] * 40, [2] * 10, [3] * 64])
    assert b.stats["truncated_prompts"] == 2
    assert b.stats["truncated_tokens"] == (40 - 32) + (64 - 32)

    def run(side):
        eng = _engine(side, 4)
        eng.batcher.max_bucket = 32
        logits = eng.first_token_logits([[1] * 50, [2] * 10])
        assert eng.stats["truncated_prompts"] == 1
        assert eng.stats["truncated_tokens"] == 18
        return eng.stats, logits.shape
    _both(run)

    for Stats in (DispatchMergeStats, JDispatchMergeStats):
        m = Stats()
        m.record([4, 4], wall_s=0.5, tokens=100, truncated=1)
        m.record([2], wall_s=0.25, tokens=40)
        assert m.n_truncated == 1
        assert m.total_tokens == 140
        assert m.mean_wall_s == pytest.approx(0.375)
        assert m.tokens_per_s == pytest.approx(140 / 0.75)
