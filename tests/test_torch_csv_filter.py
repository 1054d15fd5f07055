"""The PyTorch port's CSV filter (Algorithm 1) against the JAX reference.

Same table, same oracle seeds, and the reference's k-means++ injected
through the port's seeder hook: masks, call counts, ``cluster_log``,
``round_log`` and ``oracle_batch_sizes`` must all be equal, on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import smoke_config as jsmoke
from repro.core import clustering as jc
from repro.core import csv_filter as jcf
from repro.core.oracle import ModelOracle as JModelOracle
from repro.core.oracle import SyntheticOracle as JSyntheticOracle
from repro.data.synthetic import make_dataset
from repro.data.tokenizer import HashTokenizer
from repro.models import lm as jlm
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs import smoke_config
from repro_torch.core import csv_filter as tcf
from repro_torch.core.oracle import ModelOracle, SyntheticOracle
from repro_torch.models import lm
from repro_torch.serving import ServingEngine

_plusplus = jax.jit(jc._plusplus_init, static_argnums=2)


def jax_seeder(seed, x, k):
    """The reference's k-means++ for ``jax.random.key(seed)``."""
    return np.asarray(_plusplus(jax.random.key(seed), jnp.asarray(x), k))


# impure topics make the first clustering split badly, so rounds re-cluster
DATA = make_dataset("codebase", n=1200, dim=16, seed=2)
LABELS = DATA.labels["CB-Q2"]


def assert_same_run(got, ref):
    np.testing.assert_array_equal(got.mask, ref.mask)
    for field in ("n_llm_calls", "input_tokens", "output_tokens", "n_voted",
                  "n_fallback", "recluster_rounds", "cluster_log", "xi_used",
                  "oracle_batch_sizes", "n_input"):
        assert getattr(got, field) == getattr(ref, field), field
    assert ([dataclasses.asdict(r) for r in got.round_log]
            == [dataclasses.asdict(r) for r in ref.round_log])


def _kw(vote, executor, depth):
    return dict(vote=vote, executor=executor, pipeline_depth=depth,
                min_sample=40, n_clusters=4, seed=3)


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("executor", ["round", "sequential"])
@pytest.mark.parametrize("vote", ["uni", "sim"])
def test_semantic_filter_matches_reference(vote, executor, depth):
    ref = jcf.semantic_filter(
        DATA.embeddings, JSyntheticOracle(LABELS, flip_prob=0.05, seed=1),
        jcf.CSVConfig(**_kw(vote, executor, depth)))
    got = tcf.semantic_filter(
        DATA.embeddings, SyntheticOracle(LABELS, flip_prob=0.05, seed=1),
        tcf.CSVConfig(**_kw(vote, executor, depth)),
        init_centroids=jax_seeder, device="cpu")
    assert_same_run(got, ref)
    assert ref.recluster_rounds >= 1  # the re-cluster path ran


def test_subset_and_precomputed_assign_match_reference():
    rng = np.random.default_rng(0)
    subset = np.sort(rng.choice(len(LABELS), 700, replace=False))
    assign = rng.integers(0, 5, len(LABELS))
    for kw in (dict(subset_ids=subset), dict(precomputed_assign=assign),
               dict(subset_ids=subset, precomputed_assign=assign)):
        ref = jcf.semantic_filter(
            DATA.embeddings, JSyntheticOracle(LABELS, seed=4),
            jcf.CSVConfig(**_kw("uni", "round", 1)), **kw)
        got = tcf.semantic_filter(
            DATA.embeddings, SyntheticOracle(LABELS, seed=4),
            tcf.CSVConfig(**_kw("uni", "round", 1)),
            init_centroids=jax_seeder, device="cpu", **kw)
        assert_same_run(got, ref)


def test_model_oracle_run_matches_reference():
    """The oracle LLM leg end to end: llama SMOKE behind both engines."""
    jcfg = jsmoke("llama3.1-8b").replace(attn_impl="flash")
    tcfg = smoke_config("llama3.1-8b").replace(attn_impl="flash")
    tree = jax.tree_util.tree_map(np.asarray,
                                  jlm.init_params(jcfg, jax.random.key(0)))
    ds = make_dataset("imdb_review", n=240, dim=16, seed=5)
    tok = HashTokenizer(jcfg.vocab_size)
    pred = "the review is positive"
    jor = JModelOracle(JServingEngine(
        jcfg, jax.tree_util.tree_map(jnp.asarray, tree), max_batch=32),
        tok, pred, ds.texts)
    tor = ModelOracle(ServingEngine(
        tcfg, lm.params_from_jax(tcfg, tree, device="cpu"), max_batch=32,
        device="cpu"), tok, pred, ds.texts)
    kw = dict(vote="sim", min_sample=30, n_clusters=3, seed=1)
    ref = jcf.semantic_filter(ds.embeddings, jor, jcf.CSVConfig(**kw))
    got = tcf.semantic_filter(ds.embeddings, tor, tcf.CSVConfig(**kw),
                              init_centroids=jax_seeder, device="cpu")
    np.testing.assert_array_equal(got.mask, ref.mask)
    assert got.n_llm_calls == ref.n_llm_calls
    assert got.oracle_batch_sizes == ref.oracle_batch_sizes
    assert tor.engine.stats["batches"] == jor.engine.stats["batches"]


def test_shards_wait_for_the_distributed_slice():
    """The sharded path is ported (tests/test_torch_distributed_round.py):
    shards=2 runs and equals shards=1; a bad executor still raises."""
    runs = [tcf.semantic_filter(DATA.embeddings, SyntheticOracle(LABELS),
                                tcf.CSVConfig(shards=s, **_kw("uni", "round",
                                                               1)),
                                init_centroids=jax_seeder, device="cpu")
            for s in (1, 2)]
    np.testing.assert_array_equal(runs[1].mask, runs[0].mask)
    assert runs[1].n_llm_calls == runs[0].n_llm_calls
    assert runs[1].cluster_log == runs[0].cluster_log
    assert any(r.shards == 2 for r in runs[1].round_log)
    with pytest.raises(ValueError, match="executor"):
        tcf.semantic_filter(DATA.embeddings, SyntheticOracle(LABELS),
                            tcf.CSVConfig(executor="nope"), device="cpu")
