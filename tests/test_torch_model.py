"""The PyTorch port's model path against the JAX reference, on the CPU.

Both packages compute with the same weights: the reference's
``lm.init_params`` tree goes through ``params_from_jax``.  Attention runs
as ``attn_impl="flash"`` (the reference's Pallas kernel in interpret mode,
the port's plain version of its CUDA kernel) and as ``"plain"``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.core.oracle import ModelOracle as JModelOracle
from repro.models import lm as jlm
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.oracle import ModelOracle
from repro_torch.data import HashTokenizer, make_dataset
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import lm
from repro_torch.serving import ServingEngine

ARCHS = ["llama3.1-8b", "qwen1.5-0.5b"]
IMPLS = ["flash", "plain"]
TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _jax_params(arch: str, dtype: str = "float32"):
    """Reference weights; QKV biases get random values so they matter."""
    cfg = jsmoke(arch).replace(dtype=dtype)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jlm.init_params(cfg, jax.random.key(0)))
    rng = np.random.default_rng(1)
    attn = tree["blocks"]["l0"]["attn"]
    for name in ("bq", "bk", "bv"):
        if name in attn:
            attn[name] = (0.1 * rng.normal(size=attn[name].shape)
                          ).astype(attn[name].dtype)
    return tree


def _pair(arch, impl):
    jcfg = jsmoke(arch).replace(attn_impl=impl)
    tcfg = smoke_config(arch).replace(attn_impl=impl)
    tree = _jax_params(arch)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, jparams, tcfg, lm.params_from_jax(tcfg, tree, device="cpu")


def _prompts(n, vocab, seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, 70, n)  # spans the 32, 64 and 128 buckets
    return [rng.integers(8, vocab, int(k)).tolist() for k in lens]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_first_logits_select_matches_reference(arch, impl):
    jcfg, jparams, tcfg, tparams = _pair(arch, impl)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jcfg.vocab_size, (3, 32)).astype(np.int32)
    lens = np.array([32, 17, 5], np.int32)
    for tids in (np.array([3, 4], np.int32),
                 rng.integers(0, jcfg.vocab_size, (3, 2)).astype(np.int32)):
        ref = np.asarray(jlm.first_logits_select(
            jcfg, jparams, jnp.asarray(tokens), jnp.asarray(lens),
            jnp.asarray(tids)))
        got = lm.first_logits_select(
            tcfg, tparams, torch.from_numpy(tokens).long(),
            torch.from_numpy(lens).long(), torch.from_numpy(tids).long())
        np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_first_token_logits_matches_reference(arch, impl):
    jcfg, jparams, tcfg, tparams = _pair(arch, impl)
    jeng = JServingEngine(jcfg, jparams, max_batch=4)
    teng = ServingEngine(tcfg, tparams, max_batch=4, device="cpu")
    prompts = _prompts(9, jcfg.vocab_size)
    tids = np.tile(np.array([3, 4], np.int32), (len(prompts), 1))
    np.testing.assert_allclose(teng.first_token_logits(prompts, tids),
                               jeng.first_token_logits(prompts, tids),
                               rtol=TOL, atol=TOL)
    full = teng.first_token_logits(prompts[:4])
    assert full.shape == (4, tcfg.padded_vocab)
    np.testing.assert_allclose(full, jeng.first_token_logits(prompts[:4]),
                               rtol=TOL, atol=TOL)
    assert teng.stats == jeng.stats


@pytest.mark.parametrize("arch", ARCHS)
def test_model_oracle_decisions_match_reference(arch):
    jcfg, jparams, tcfg, tparams = _pair(arch, "flash")
    ds = make_dataset("imdb_review", n=48, dim=8)
    tok = HashTokenizer(jcfg.vocab_size)
    jeng = JServingEngine(jcfg, jparams, max_batch=16)
    jor = JModelOracle(jeng, tok, "the review is positive", ds.texts)
    tor = ModelOracle(ServingEngine(tcfg, tparams, max_batch=16,
                                    device="cpu"),
                      tok, "the review is positive", ds.texts)
    ids = np.arange(48)
    pair = jeng.first_token_logits(jor.pack_prompts(ids),
                                   token_ids=jor.pack_token_ids(len(ids)))
    clear = np.abs(pair[:, 0] - pair[:, 1]) > 1e-3
    got, ref = tor(ids), jor(ids)
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got[clear], ref[clear])
    assert tor.stats.n_calls == jor.stats.n_calls
    assert tor.stats.input_tokens == jor.stats.input_tokens


@pytest.mark.parametrize("S,flash", [(48, True), (200, False)])
def test_attention_routing_matches_reference(S, flash, monkeypatch):
    """S % min(128, S) decides flash or plain, in both packages."""
    jcfg, jparams, tcfg, tparams = _pair("llama3.1-8b", "flash")
    calls = []
    real = flash_ops.flash_attention
    monkeypatch.setattr(flash_ops, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tokens = np.random.default_rng(S).integers(0, 512, (2, S))
    ref, _ = jlm.forward(jcfg, jparams, jnp.asarray(tokens, jnp.int32))
    got, _ = lm.forward(tcfg, tparams, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)
    assert bool(calls) == flash


def test_init_params_matches_reference_layout():
    for arch in ARCHS:
        cfg = smoke_config(arch)
        got = lm.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        ref = lm.params_from_jax(cfg, _jax_params(arch), device="cpu")
        flat = lambda t: {k: v for k, v in _flatten(t)}  # noqa: E731
        g, r = flat(got), flat(ref)
        assert g.keys() == r.keys()
        for k in g:
            assert g[k].shape == r[k].shape and g[k].dtype == r[k].dtype, k
        assert sum(v.numel() for v in g.values()) == cfg.param_count()
    # bf16 configs: weights in bf16, norm scales in f32, as the reference
    cfg = smoke_config("llama3.1-8b").replace(dtype="bfloat16")
    got = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref = lm.params_from_jax(cfg, _jax_params("llama3.1-8b", "bfloat16"),
                             device="cpu")
    assert got["blocks"][0]["l0"]["attn"]["wq"].dtype == torch.bfloat16
    assert got["final_norm"]["scale"].dtype == torch.float32
    np.testing.assert_array_equal(
        ref["embed"]["table"].float().numpy(),
        _jax_params("llama3.1-8b", "bfloat16")["embed"]["table"].astype(
            np.float32))


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_full_width_oracle_config_is_the_published_one():
    cfg = get_config("llama3.1-8b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size, cfg.dtype) == (
        32, 4096, 32, 8, 128, 14336, 128256, "bfloat16")


def test_serving_engine_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_config("llama3.1-8b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_params(cfg, torch.Generator())
