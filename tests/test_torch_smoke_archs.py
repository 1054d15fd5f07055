"""The port's architecture registry against the JAX reference, on the CPU.

For each of the ten assigned architectures of the reference's
``tests/test_smoke_archs.py`` and the paper's proxy ``llama3.2-3b-proxy``:
``CONFIG`` and ``SMOKE`` equal field for field, ``param_count`` and the
initialised tensor count equal to the reference's, and the smoke forward's
logits (within ``TOL``, float32) and MoE aux (within ``AUX_RTOL``) equal
to the reference's with the same weights (the reference's ``init_params``
tree through ``lm.params_from_jax``).  ``ServingEngine`` on the jamba and
falcon-mamba smoke configs: yes/no logits within ``TOL`` and greedy
streams and stats equal to the reference engine's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.serving.engine import ServingEngine as JServingEngine
from repro.utils.tree import tree_param_count
from repro_torch import configs
from repro_torch.models import lm
from repro_torch.serving import ServingEngine

ASSIGNED = ["falcon-mamba-7b", "mixtral-8x22b", "dbrx-132b", "internvl2-26b",
            "gemma3-12b", "stablelm-12b", "codeqwen1.5-7b", "qwen1.5-0.5b",
            "jamba-v0.1-52b", "whisper-base"]
ARCHS = ASSIGNED + ["llama3.2-3b-proxy"]
TOL = 1e-4
AUX_RTOL = 1e-6


@functools.lru_cache(maxsize=None)
def _tree(arch: str):
    return jax.tree_util.tree_map(
        np.asarray, jlm.init_params(jconfigs.smoke_config(arch),
                                    jax.random.key(0)))


def _numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_numel(v) for v in tree)
    return tree.numel()


def _inputs(cfg, B=2, S=32, seed=0):
    """Tokens and the modality stubs the config takes, as numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.num_prefix_embeds:
        out["prefix_embeds"] = rng.normal(
            size=(B, cfg.num_prefix_embeds, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        out["enc_frames"] = rng.normal(
            size=(B, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_param_count_match_reference(arch):
    for j, t in ((jconfigs.get_config(arch), configs.get_config(arch)),
                 (jconfigs.smoke_config(arch), configs.smoke_config(arch))):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
    cfg = configs.smoke_config(arch)
    n = _numel(lm.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu"))
    assert n == tree_param_count(_tree(arch))
    if arch == "whisper-base":
        # the reference's analytic count prices the encoder as SwiGLU
        # without LayerNorm biases; its own tree disagrees the same way
        assert n != cfg.param_count()
    else:
        assert n == cfg.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_matches_reference(arch):
    jcfg, tcfg = jconfigs.smoke_config(arch), configs.smoke_config(arch)
    inputs = _inputs(tcfg)
    ref, ref_aux = jlm.forward(
        jcfg, jax.tree_util.tree_map(jnp.asarray, _tree(arch)),
        **{k: jnp.asarray(v) for k, v in inputs.items()})
    got, aux = lm.forward(
        tcfg, lm.params_from_jax(tcfg, _tree(arch), device="cpu"),
        **{k: torch.from_numpy(v) for k, v in inputs.items()})
    B, S = inputs["tokens"].shape
    assert got.shape == (B, S + tcfg.num_prefix_embeds, tcfg.padded_vocab)
    assert torch.isfinite(got).all() and torch.isfinite(aux)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=AUX_RTOL)


def test_registry_matches_reference():
    assert configs.list_archs() == jconfigs.list_archs()
    assert configs.LONG_CONTEXT_OK == jconfigs.LONG_CONTEXT_OK
    for arch in configs.list_archs():
        assert configs.long_context_skip_reason(arch) == \
            jconfigs.long_context_skip_reason(arch)
        cfg = configs.get_config(arch)
        if cfg.family == "encoder":  # the embedding encoder's own path
            with pytest.raises(ValueError, match="encoder"):
                lm._check_supported(cfg)
        else:  # every decoder config of the registry runs
            lm._check_supported(cfg)


# --------------------------------------------------------------- engine
ENGINE_ARCHS = [("jamba-v0.1-52b", "flash"), ("falcon-mamba-7b", "auto")]


def _engines(arch, impl):
    jcfg = jconfigs.smoke_config(arch).replace(attn_impl=impl)
    tcfg = configs.smoke_config(arch).replace(attn_impl=impl)
    return (JServingEngine(jcfg, jax.tree_util.tree_map(jnp.asarray,
                                                        _tree(arch)),
                           max_batch=4),
            ServingEngine(tcfg, lm.params_from_jax(tcfg, _tree(arch),
                                                   device="cpu"),
                          max_batch=4, device="cpu"))


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, 45, n)  # the 32 and 64 buckets, ragged
    return [rng.integers(8, 512, int(k)).tolist() for k in lens]


@pytest.mark.parametrize("arch,impl", ENGINE_ARCHS)
def test_engine_first_token_logits_match_reference(arch, impl):
    jeng, teng = _engines(arch, impl)
    prompts = _prompts(7, seed=1)
    tids = np.array([3, 4], np.int32)
    np.testing.assert_allclose(teng.first_token_logits(prompts, tids),
                               jeng.first_token_logits(prompts, tids),
                               rtol=TOL, atol=TOL)
    per_prompt = np.random.default_rng(2).integers(0, 512, (7, 2))
    np.testing.assert_allclose(teng.first_token_logits(prompts, per_prompt),
                               jeng.first_token_logits(prompts, per_prompt),
                               rtol=TOL, atol=TOL)
    assert teng.stats == jeng.stats


@pytest.mark.parametrize("arch,impl", ENGINE_ARCHS)
def test_engine_generate_matches_reference(arch, impl):
    """Greedy streams over ragged batches: the Mamba state takes in each
    batch's right padding in both packages alike."""
    jeng, teng = _engines(arch, impl)
    prompts = _prompts(6, seed=3)
    assert teng.generate(prompts, max_new=8) == jeng.generate(prompts,
                                                              max_new=8)
    assert teng.stats == jeng.stats
