"""The port's chunked attention schedules against the JAX reference.

``attention_chunked`` (banded sliding window, the ``tri`` triangle-packed
causal schedule, the masked rectangle) and the reference's dispatch under
``attn_impl="auto"``: the cases of tests/test_models.py (each schedule
against plain attention), then ``forward``/``prefill`` logits of the gemma
and llama smoke configs at S above ``attn_chunk_q`` against the reference's
within 1e-4, and greedy gemma streams under ``"auto"`` equal to the
reference's.  Weights are the reference's ``init_params`` tree carried
across by ``lm.params_from_jax``.  On the card (marked ``cuda``): each
schedule in f32 against plain attention on the CPU, and in bf16 against
the same schedule on the CPU.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.models import layers, lm
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.serving import ServingEngine

BASE = dict(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
            dtype="float32", attn_chunk_q=16, attn_chunk_kv=16)


@pytest.fixture(scope="module")
def jx():
    """The JAX reference's lm, configs and engine."""
    pytest.importorskip("jax")
    import types

    import jax
    import jax.numpy as jnp

    from repro.configs import smoke_config as jsmoke
    from repro.models import lm as jlm
    from repro.models.config import LayerSpec as JLayerSpec
    from repro.models.config import ModelConfig as JModelConfig
    from repro.serving.engine import ServingEngine as JServingEngine
    return types.SimpleNamespace(jax=jax, jnp=jnp, smoke=jsmoke, lm=jlm,
                                 LayerSpec=JLayerSpec,
                                 ModelConfig=JModelConfig,
                                 Engine=JServingEngine)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _tree(key):
    """The reference's init_params tree (numpy) for a config key."""
    import jax
    from repro.models import lm as jlm
    return jax.tree_util.tree_map(np.asarray,
                                  jlm.init_params(_jcfg(key),
                                                  jax.random.key(0)))


def _jcfg(key):
    from repro.configs import smoke_config as jsmoke
    from repro.models.config import LayerSpec as JLayerSpec
    from repro.models.config import ModelConfig as JModelConfig
    if key in ("gemma3-12b", "llama3.1-8b"):
        return jsmoke(key)
    window = None if key == "dense" else 24
    return JModelConfig(name="t", family="dense", n_layers=2,
                        pattern=(JLayerSpec(window=window),), **BASE)


def _tcfg(key):
    if key in ("gemma3-12b", "llama3.1-8b"):
        return smoke_config(key)
    window = None if key == "dense" else 24
    return ModelConfig(name="t", family="dense", n_layers=2,
                       pattern=(LayerSpec(window=window),), **BASE)


def _tokens(B, S, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _forward(cfg, params, tokens):
    logits, _ = lm.forward(cfg, params, torch.from_numpy(tokens).long())
    return logits.numpy()


# ------------------------------------- the reference's test_models cases
@pytest.mark.parametrize("impl", ["chunked", "tri"])
def test_attention_impls_match_plain(jx, impl):
    cfg = _tcfg("dense")
    params = lm.params_from_jax(cfg, _tree("dense"), device="cpu")
    tokens = _tokens(2, 64, 256)
    ref = _forward(cfg.replace(attn_impl="plain"), params, tokens)
    got = _forward(cfg.replace(attn_impl=impl), params, tokens)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    jref, _ = jx.lm.forward(_jcfg("dense").replace(attn_impl=impl),
                            jx.jax.tree_util.tree_map(jx.jnp.asarray,
                                                      _tree("dense")),
                            jx.jnp.asarray(tokens))
    np.testing.assert_allclose(got, np.asarray(jref), rtol=1e-4, atol=1e-4)


def test_banded_swa_matches_plain(jx):
    cfg = _tcfg("swa")
    params = lm.params_from_jax(cfg, _tree("swa"), device="cpu")
    tokens = _tokens(2, 64, 256)
    ref = _forward(cfg.replace(attn_impl="plain"), params, tokens)
    got = _forward(cfg.replace(attn_impl="chunked", swa_banded=True), params,
                   tokens)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    jref, _ = jx.lm.forward(
        _jcfg("swa").replace(attn_impl="chunked", swa_banded=True),
        jx.jax.tree_util.tree_map(jx.jnp.asarray, _tree("swa")),
        jx.jnp.asarray(tokens))
    np.testing.assert_allclose(got, np.asarray(jref), rtol=1e-4, atol=1e-4)


# ------------------------------------ smoke configs against the reference
CASES = [("gemma3-12b", "auto", True), ("gemma3-12b", "chunked", True),
         ("gemma3-12b", "chunked", False), ("gemma3-12b", "tri", True),
         ("gemma3-12b", "tri", False), ("llama3.1-8b", "chunked", True),
         ("llama3.1-8b", "tri", True)]


@pytest.mark.parametrize("arch,impl,banded", CASES)
def test_forward_and_prefill_match_reference(jx, arch, impl, banded):
    """S 48 > attn_chunk_q 16: three q chunks; gemma's window 16 makes the
    banded schedule cross chunk edges."""
    tcfg = _tcfg(arch).replace(attn_impl=impl, swa_banded=banded)
    jcfg = _jcfg(arch).replace(attn_impl=impl, swa_banded=banded)
    params = lm.params_from_jax(tcfg, _tree(arch), device="cpu")
    jparams = jx.jax.tree_util.tree_map(jx.jnp.asarray, _tree(arch))
    tokens = _tokens(2, 48, 512, seed=3)
    jlogits, _ = jx.lm.forward(jcfg, jparams, jx.jnp.asarray(tokens))
    got = _forward(tcfg, params, tokens)
    np.testing.assert_allclose(got, np.asarray(jlogits), rtol=1e-4,
                               atol=1e-4)
    jp, _, _ = jx.lm.prefill(jcfg, jparams, jx.jnp.asarray(tokens),
                             max_len=56)
    tp, _, _ = lm.prefill(tcfg, params, torch.from_numpy(tokens).long(),
                          max_len=56)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-4,
                               atol=1e-4)


def test_auto_routes_gemma_windows_to_the_banded_schedule(monkeypatch):
    """Under "auto" the sliding-window layers take attention_chunked (the
    reference's dispatch) and the global layer plain attention."""
    cfg = smoke_config("gemma3-12b")
    assert cfg.attn_impl == "auto"
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    calls = []
    real = layers.attention_chunked

    def spy(*a, **kw):
        calls.append(kw.get("window"))
        return real(*a, **kw)

    monkeypatch.setattr(layers, "attention_chunked", spy)
    lm.forward(cfg, params, torch.zeros((1, 32), dtype=torch.long))
    windows = [s.window for s in cfg.pattern if s.window is not None]
    assert calls == windows * cfg.n_superblocks


def test_banded_schedule_takes_a_batch_of_one():
    """B 1, where ``positions`` has one row per batch row and the banded
    schedule takes its q rows from it: equal to plain attention."""
    cfg = smoke_config("gemma3-12b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    tokens = _tokens(1, 48, 512, seed=4)
    ref = _forward(cfg.replace(attn_impl="plain"), params, tokens)
    np.testing.assert_allclose(_forward(cfg, params, tokens), ref,
                               rtol=2e-4, atol=2e-4)


def test_chunked_refuses_a_ragged_kv_chunk():
    cfg = _tcfg("dense").replace(attn_chunk_q=16, attn_chunk_kv=24)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    x = torch.zeros((1, 32, cfg.d_model))
    with pytest.raises(ValueError, match="multiple"):
        layers.attention_chunked(cfg, params["blocks"][0]["l0"]["attn"], x,
                                 causal=True)


def test_gemma_auto_greedy_streams_match_reference(jx):
    """Greedy generate on the gemma smoke config under "auto": its window
    layers prefill through the banded schedule in both packages."""
    tcfg, jcfg = _tcfg("gemma3-12b"), _jcfg("gemma3-12b")
    assert tcfg.attn_impl == jcfg.attn_impl == "auto"
    params = lm.params_from_jax(tcfg, _tree("gemma3-12b"), device="cpu")
    jparams = jx.jax.tree_util.tree_map(jx.jnp.asarray, _tree("gemma3-12b"))
    rng = np.random.default_rng(0)
    # 8 prompts of the 64-token bucket: two batches of 4.  A batch of one
    # is left out: there the reference's banded schedule slices its
    # positions with a traced index and fails to trace (layers.py:223;
    # see test_banded_schedule_takes_a_batch_of_one)
    prompts = [rng.integers(8, 512, int(k)).tolist()
               for k in rng.integers(33, 60, 8)]
    teng = ServingEngine(tcfg, params, max_batch=4, device="cpu")
    jeng = jx.Engine(jcfg, jparams, max_batch=4)
    assert teng.generate(prompts, max_new=20) == jeng.generate(prompts,
                                                               max_new=20)
    assert teng.stats == jeng.stats


# ------------------------------------------------------------- the card
def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 0.25)])
@pytest.mark.parametrize("impl,banded", [("auto", True), ("chunked", True),
                                         ("chunked", False), ("tri", True)])
def test_cuda_chunked_matches_cpu(cuda, impl, banded, dtype, tol):
    """gemma smoke at S 64, each schedule on the card.  f32: against plain
    attention on the CPU (1e-4, the parity tolerance).  bf16: against the
    same schedule on the CPU, within chip_smoke.py's CHUNK_LIMIT 0.25 (the
    schedules round their unnormalised probabilities to bf16 where plain
    attention rounds normalised ones: 0.09 between them at this width on
    the CPU, 0.095 at full width on the card); a wrong mask moves the
    logits by units."""
    cfg = smoke_config("gemma3-12b").replace(dtype=dtype)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    tokens = torch.from_numpy(_tokens(2, 64, 512, seed=5)).long()
    run = cfg.replace(attn_impl=impl, swa_banded=banded)
    want, _ = lm.forward(run if dtype == "bfloat16"
                         else cfg.replace(attn_impl="plain"), params, tokens)
    got, _ = lm.forward(run, _to(params, cuda), tokens.to(cuda))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=tol,
                               atol=tol)
