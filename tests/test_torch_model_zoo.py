"""The PyTorch port's model zoo against the JAX reference, on the CPU.

Every roundtrip of the reference's ``tests/test_models.py`` (dense GQA,
QKV bias, Mamba, MoE, the SWA ring, the hybrid superblock, the
encoder-decoder and the VLM prefix) runs on both packages with the same
weights (the reference's ``init_params`` tree through
``lm.params_from_jax``): forward, prefill and teacher-forced decode
logits within ``TOL`` in float32, prefill caches within ``CACHE_TOL``.
The MoE router's experts, kept slots and dispatch rows are compared
exactly (ties included), the Switch aux within one float32 rounding;
``apply_moe``'s chunked path, Mamba's multi-chunk carry, both routes of
its scan (K6's op without autograd, the chunked recurrence with it) and
``mamba_decode`` against ``mamba_scan`` each within ``LAYER_TOL``.  The
two reference behaviours that ROADMAP.md records (Mamba state absorbing
right padding; MoE capacity depending on the bucket length) are shown on
both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models.config import LayerSpec as JLayerSpec
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.configs import smoke_config
from repro_torch.kernels.selective_scan.kernel import selective_scan_cuda
from repro_torch.models import layers, lm
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.obs.trace import Tracer, use_tracer

TOL = 1e-4         # logits, float32, against the reference
CACHE_TOL = 1e-5   # prefill caches (K/V, Mamba state and window)
LAYER_TOL = 1e-5   # one layer's output (MoE, Mamba), float32
AUX_RTOL = 1e-6    # the Switch aux: one float32 rounding
BASE = dict(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
            dtype="float32", attn_chunk_q=16, attn_chunk_kv=16, ssm_chunk=8)
HYBRID = (("mamba", None, "dense"), ("mamba", None, "moe"),
          ("attn", None, "dense"), ("mamba", None, "moe"))
# the roundtrips of tests/test_models.py:40-88: (name, family, n_layers,
# pattern as (kind, window, ffn), extra fields, inputs)
CASES = {
    "dense_gqa": ("dense", 4, (("attn", None, "dense"),), {}, None),
    "qkv_bias": ("dense", 2, (("attn", None, "dense"),),
                 dict(qkv_bias=True), None),
    "mamba": ("ssm", 4, (("mamba", None, "none"),), {}, None),
    "moe": ("moe", 4, (("attn", None, "moe"),),
            dict(n_experts=4, top_k=2, capacity_factor=8.0, moe_chunk=0),
            None),
    "swa_ring": ("dense", 4, (("attn", 16, "dense"),), {}, None),
    "hybrid": ("hybrid", 8, HYBRID,
               dict(n_experts=4, top_k=2, capacity_factor=8.0, moe_chunk=0),
               None),
    "encdec": ("audio", 2, (("attn", None, "dense"),),
               dict(encoder_layers=2, encoder_len=12, norm_type="ln",
                    pos_type="sinusoidal", mlp_type="gelu"), "enc_frames"),
    "vlm_prefix": ("vlm", 2, (("attn", None, "dense"),),
                   dict(num_prefix_embeds=4), "prefix_embeds"),
}


def _cfgs(family, n_layers, pattern, extra, **over):
    """The same config in both packages."""
    kw = dict(BASE, name="t", family=family, n_layers=n_layers, **extra)
    kw.update(over)
    return (JModelConfig(pattern=tuple(JLayerSpec(k, w, f)
                                       for k, w, f in pattern), **kw),
            ModelConfig(pattern=tuple(LayerSpec(k, w, f)
                                      for k, w, f in pattern), **kw))


def _params(jcfg, tcfg, seed=0):
    tree = jax.tree_util.tree_map(np.asarray,
                                  jlm.init_params(jcfg, jax.random.key(seed)))
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            lm.params_from_jax(tcfg, tree, device="cpu"))


def _extra_inputs(cfg, which, B, seed=5):
    """The roundtrip's prefix embeddings or encoder frames, as numpy."""
    if which is None:
        return {}
    rng = np.random.default_rng(seed)
    n = cfg.num_prefix_embeds if which == "prefix_embeds" else cfg.encoder_len
    return {which: rng.normal(size=(B, n, cfg.d_model)).astype(np.float32)}


def _both(inputs):
    return ({k: jnp.asarray(v) for k, v in inputs.items()},
            {k: torch.from_numpy(v) for k, v in inputs.items()})


def _stack_cache(cache):
    """The port's per-superblock cache as the reference's stacked numpy."""
    return {name: {k: np.stack([sb[name][k].float().numpy() for sb in cache])
                   for k in cache[0][name]}
            for name in cache[0]}


def _assert_cache_close(got, ref, tol):
    got = _stack_cache(got)
    ref = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), ref)
    assert got.keys() == ref.keys()
    for name in ref:
        assert got[name].keys() == ref[name].keys(), name
        for k in ref[name]:
            np.testing.assert_allclose(got[name][k], ref[name][k], rtol=tol,
                                       atol=tol, err_msg=f"{name}/{k}")


# ------------------------------------------------------------ roundtrips
@pytest.mark.parametrize("case", list(CASES))
def test_roundtrip_matches_reference(case):
    """forward, prefill (logits and cache) and three decode steps, the
    reference's greedy tokens fed to both packages; then the port's last
    decode logits against its own forward over the grown sequence, as the
    reference's roundtrip checks itself (3e-4 and 1e-3 there)."""
    family, n_layers, pattern, extra, which = CASES[case]
    jcfg, tcfg = _cfgs(family, n_layers, pattern, extra)
    jp, tp = _params(jcfg, tcfg)
    B, S, steps, P = 2, 32, 3, tcfg.num_prefix_embeds
    tokens = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (B, S)).astype(np.int32)
    jkw, tkw = _both(_extra_inputs(tcfg, which, B))

    ref, ref_aux = jlm.forward(jcfg, jp, jnp.asarray(tokens), **jkw)
    got, aux = lm.forward(tcfg, tp, torch.from_numpy(tokens).long(), **tkw)
    assert got.shape == (B, S + P, tcfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=AUX_RTOL)

    jl_p, jcache, jpos = jlm.prefill(jcfg, jp, jnp.asarray(tokens),
                                     max_len=P + S + steps, **jkw)
    tl_p, cache, pos = lm.prefill(tcfg, tp, torch.from_numpy(tokens).long(),
                                  max_len=P + S + steps, **tkw)
    np.testing.assert_allclose(tl_p.numpy(), np.asarray(jl_p), rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    _assert_cache_close(cache, jcache, CACHE_TOL)

    toks, src = tokens, np.asarray(jl_p)[:, -1]
    for step in range(steps):
        tok = np.argmax(src, -1).astype(np.int32)
        ref_d, jcache = jlm.decode_step(jcfg, jp, jcache, jnp.asarray(tok),
                                        jpos)
        got_d, cache = lm.decode_step(tcfg, tp, cache,
                                      torch.from_numpy(tok).long(), pos)
        np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d),
                                   rtol=TOL, atol=TOL, err_msg=f"step {step}")
        jpos, pos = jpos + 1, pos + 1
        toks = np.concatenate([toks, tok[:, None]], axis=1)
        src = np.asarray(ref_d)
    _assert_cache_close(cache, jcache, TOL)
    full, _ = lm.forward(tcfg, tp, torch.from_numpy(toks).long(), **tkw)
    np.testing.assert_allclose(got_d.numpy(), full[:, -1].numpy(), rtol=1e-3,
                               atol=1e-3)


def test_encdec_needs_frames():
    jcfg, tcfg = _cfgs(*CASES["encdec"][:4])
    _, tp = _params(jcfg, tcfg)
    with pytest.raises(ValueError, match="enc_frames"):
        lm.forward(tcfg, tp, torch.zeros((1, 4), dtype=torch.long))


# ------------------------------------------------------------------ MoE
def _jax_route(cfg, p, x):
    """The reference's routing, line for line from ``moe_ffn_tokens``
    (repro/models/layers.py:490-507): topi, keep, dst and C."""
    B, T, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    logits = jnp.einsum("btd,de->bte", x.astype(jnp.float32), p["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    topv, topi = lax.top_k(probs, K)
    C = jlayers._round_up(max(1, int(K * T / E * cfg.capacity_factor)), 8)
    C = min(C, T)
    flat_e = topi.reshape(B, T * K)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    ranks = jnp.take_along_axis(jnp.cumsum(onehot, axis=1),
                                flat_e[..., None], axis=2)[..., 0] - 1
    keep = ranks < C
    dst = jnp.where(keep, flat_e * C + ranks, E * C)
    return (np.asarray(topi), np.asarray(keep), np.asarray(dst), C,
            np.asarray(topv / jnp.sum(topv, axis=-1, keepdims=True)))


def _moe_layer(capacity_factor, E=4, K=2, zero_router=False, moe_chunk=0,
               seed=0):
    jcfg, tcfg = _cfgs("moe", 2, (("attn", None, "moe"),),
                       dict(n_experts=E, top_k=K, moe_chunk=moe_chunk,
                            capacity_factor=capacity_factor))
    jp = jlayers.init_moe(jax.random.key(seed), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    if zero_router:  # every probability exactly 1/E: all experts tie
        tree["router"] = np.zeros_like(tree["router"])
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("capacity_factor,zero_router",
                         [(8.0, False), (1.0, False), (0.5, False),
                          (1.25, True)])
def test_moe_routing_and_drops_match_reference_exactly(capacity_factor,
                                                       zero_router):
    jcfg, tcfg, jp, tp = _moe_layer(capacity_factor, zero_router=zero_router)
    x = np.random.default_rng(2).normal(size=(3, 32, 64)).astype(np.float32)
    topi, keep, dst, C, topv = _jax_route(jcfg, jp, jnp.asarray(x))
    _, got_v, got_i, got_c, got_keep, got_dst = layers.moe_route(
        tcfg, tp, torch.from_numpy(x))
    assert got_c == C
    np.testing.assert_array_equal(got_i.numpy(), topi)
    np.testing.assert_array_equal(got_keep.numpy(), keep)
    np.testing.assert_array_equal(got_dst.numpy(), dst)
    np.testing.assert_allclose(got_v.numpy(), topv, rtol=1e-6, atol=1e-7)
    if capacity_factor < 8.0:  # the case drops tokens
        assert not keep.all()
    if zero_router:  # ties go to the lower expert index, as lax.top_k
        assert (topi == np.arange(2)).all()
    ref, ref_aux = jlayers.moe_ffn_tokens(jcfg, jp, jnp.asarray(x))
    out, aux = layers.moe_ffn_tokens(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=LAYER_TOL,
                               atol=LAYER_TOL)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=AUX_RTOL)


@pytest.mark.parametrize("moe_chunk,S", [(16, 32), (16, 24), (0, 32),
                                         (32, 32)])
def test_apply_moe_chunks_match_reference(moe_chunk, S):
    """Chunked at S 32 over 16-token groups (aux averaged); unchunked when
    S does not divide, when the chunk is off or when S <= chunk."""
    jcfg, tcfg, jp, tp = _moe_layer(1.0, moe_chunk=moe_chunk)
    x = np.random.default_rng(3).normal(size=(2, S, 64)).astype(np.float32)
    ref, ref_aux = jlayers.apply_moe(jcfg, jp, jnp.asarray(x))
    out, aux = layers.apply_moe(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=LAYER_TOL,
                               atol=LAYER_TOL)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=AUX_RTOL)
    if moe_chunk == 16 and S == 32:  # the groups are the chunks
        whole, _ = layers.moe_ffn_tokens(tcfg, tp, torch.from_numpy(x))
        assert not torch.allclose(out, whole, atol=1e-3)


# ---------------------------------------------------------------- Mamba
def _mamba_layer(ssm_chunk, seed=0):
    jcfg, tcfg = _cfgs("ssm", 2, (("mamba", None, "none"),), {},
                       ssm_chunk=ssm_chunk)
    tree = jax.tree_util.tree_map(
        np.asarray, jlayers.init_mamba(jax.random.key(seed), jcfg))
    rng = np.random.default_rng(seed + 1)
    # a nonzero conv bias and a spread of dt so every term matters
    tree["conv_b"] = 0.1 * rng.normal(size=tree["conv_b"].shape).astype(
        np.float32)
    tree["dt_bias"] = rng.uniform(-5, 0, tree["dt_bias"].shape).astype(
        np.float32)
    return (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree),
            {k: torch.from_numpy(np.array(v)) for k, v in tree.items()})


def test_mamba_init_is_the_reference_init():
    cfg = smoke_config("falcon-mamba-7b")
    jp = jlayers.init_mamba(jax.random.key(0), cfg)
    tp = lm.init_layer(cfg, cfg.pattern[0], torch.Generator().manual_seed(0),
                       torch.device("cpu"))["mamba"]
    assert tp.keys() == jp.keys()
    for name in ("D", "dt_bias", "conv_b"):
        np.testing.assert_array_equal(tp[name].numpy(), np.asarray(jp[name]))
    # log(1..ssm_state) rounded once to float32 (XLA's float32 log may
    # round the other way: one unit in the last place)
    np.testing.assert_allclose(tp["A_log"].numpy(), np.asarray(jp["A_log"]),
                               rtol=1.2e-7, atol=0)
    for name in ("A_log", "D", "dt_bias"):
        assert tp[name].dtype == torch.float32


@pytest.mark.parametrize("ssm_chunk,S", [(8, 20), (8, 16), (256, 20),
                                         (1, 5)])
def test_mamba_scan_chunks_match_reference(ssm_chunk, S):
    """Multi-chunk carry (8 at S 20: two chunks and a tail of 4), whole
    chunks, one chunk, and chunks of one step; from a zero state and from
    a given state and window."""
    jcfg, tcfg, jp, tp = _mamba_layer(ssm_chunk)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, S, 64)).astype(np.float32)
    h0 = rng.normal(size=(2, tcfg.d_inner, tcfg.ssm_state)).astype(np.float32)
    conv0 = rng.normal(size=(2, tcfg.ssm_conv - 1, tcfg.d_inner)).astype(
        np.float32)
    for state in ({}, {"h0": h0, "conv0": conv0}):
        ref, (rh, rconv) = jlayers.mamba_scan(
            jcfg, jp, jnp.asarray(x),
            **{k: jnp.asarray(v) for k, v in state.items()})
        got, (gh, gconv) = layers.mamba_scan(
            tcfg, tp, torch.from_numpy(x),
            **{k: torch.from_numpy(v) for k, v in state.items()})
        for a, b in ((got, ref), (gh, rh), (gconv, rconv)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=LAYER_TOL, atol=LAYER_TOL)
        assert gh.dtype == torch.float32


def _scan_routes(run):
    """``run()``'s result and how many ``mamba_scan`` calls took K6's op
    and the chunked recurrence, read from the tracer's counters."""
    with use_tracer(Tracer()) as tr:
        out = run()
    snap = tr.metrics.snapshot()
    return out, (snap.get("mamba.scan_kernel", 0),
                 snap.get("mamba.scan_plain", 0))


@pytest.mark.parametrize("S", [1, 17, 40])
@pytest.mark.parametrize("given", [False, True], ids=["zeros", "h0"])
def test_mamba_scan_routes_match_each_other_and_reference(S, given):
    """Without autograd the scan takes K6's op (on the CPU its plain
    version, launching nothing); with a parameter that requires grad it
    takes the chunked recurrence.  Both give the reference's y and final
    state, at ssm_chunk 16 (S 17 and 40 end in a tail chunk), from zeros
    and from a given state; they run the same float32 steps, so they
    agree exactly."""
    jcfg, tcfg, jp, tp = _mamba_layer(16)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, S, 64)).astype(np.float32)
    state = {}
    if given:
        state = {"h0": rng.normal(size=(2, tcfg.d_inner, tcfg.ssm_state)),
                 "conv0": rng.normal(size=(2, tcfg.ssm_conv - 1,
                                           tcfg.d_inner))}
        state = {k: v.astype(np.float32) for k, v in state.items()}
    ref, (rh, _) = jlayers.mamba_scan(
        jcfg, jp, jnp.asarray(x), **{k: jnp.asarray(v)
                                     for k, v in state.items()})
    args = {k: torch.from_numpy(v) for k, v in state.items()}
    launches = selective_scan_cuda.launches
    with torch.no_grad():
        (op_y, (op_h, _)), routes = _scan_routes(
            lambda: layers.mamba_scan(tcfg, tp, torch.from_numpy(x), **args))
    assert routes == (1, 0)
    grad_p = {k: v.clone().requires_grad_(k == "D") for k, v in tp.items()}
    (rec_y, (rec_h, _)), routes = _scan_routes(
        lambda: layers.mamba_scan(tcfg, grad_p, torch.from_numpy(x), **args))
    assert routes == (0, 1)
    assert selective_scan_cuda.launches == launches
    assert torch.equal(op_y, rec_y.detach())
    assert torch.equal(op_h, rec_h.detach())
    for got, want in ((op_y, ref), (op_h, rh)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=LAYER_TOL, atol=LAYER_TOL)
    rec_y.sum().backward()  # the recurrence still differentiates
    assert grad_p["D"].grad is not None and grad_p["D"].grad.abs().sum() > 0


def test_mamba_scan_on_meta_takes_the_stand_in():
    """A meta tensor (the dry run) takes the chunked recurrence, whose
    carry is one operation on meta, and so counts what it counted before
    K6."""
    _, tcfg, _, tp = _mamba_layer(8)
    meta = {k: v.to("meta") for k, v in tp.items()}
    with torch.no_grad():
        (y, (h, _)), routes = _scan_routes(lambda: layers.mamba_scan(
            tcfg, meta, torch.empty((2, 20, 64), device="meta")))
    assert routes == (0, 1)
    assert y.is_meta and tuple(h.shape) == (2, tcfg.d_inner, tcfg.ssm_state)


def test_mamba_decode_matches_scan_and_reference():
    """Steps of ``mamba_decode`` from a zero state give the scan's outputs
    and final state; each step equals the reference's step."""
    jcfg, tcfg, jp, tp = _mamba_layer(8)
    x = np.random.default_rng(5).normal(size=(2, 11, 64)).astype(np.float32)
    ys, (h_scan, conv_scan) = layers.mamba_scan(tcfg, tp, torch.from_numpy(x))
    state = {"h": torch.zeros((2, tcfg.d_inner, tcfg.ssm_state)),
             "conv": torch.zeros((2, tcfg.ssm_conv - 1, tcfg.d_inner))}
    jstate = {k: jnp.asarray(v.numpy()) for k, v in state.items()}
    for t in range(x.shape[1]):
        x1 = x[:, t:t + 1]
        ref, jstate = jlayers.mamba_decode(jcfg, jp, jnp.asarray(x1), jstate)
        before = {k: v.clone() for k, v in state.items()}
        y, state_new = layers.mamba_decode(tcfg, tp, torch.from_numpy(x1),
                                           state)
        for k in state:  # the old state is left as it was
            assert torch.equal(state[k], before[k])
        state = state_new
        np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=LAYER_TOL,
                                   atol=LAYER_TOL)
        np.testing.assert_allclose(y[:, 0].numpy(), ys[:, t].numpy(),
                                   rtol=LAYER_TOL, atol=LAYER_TOL)
        for k in ("h", "conv"):
            np.testing.assert_allclose(state[k].numpy(),
                                       np.asarray(jstate[k]), rtol=LAYER_TOL,
                                       atol=LAYER_TOL)
    np.testing.assert_allclose(state["h"].numpy(), h_scan.numpy(),
                               rtol=LAYER_TOL, atol=LAYER_TOL)
    np.testing.assert_allclose(state["conv"].numpy(), conv_scan.numpy(),
                               rtol=LAYER_TOL, atol=LAYER_TOL)


# ------------------------------------------------------ cross-attention
def test_cross_attention_decode_matches_reference():
    jcfg, tcfg = _cfgs(*CASES["encdec"][:4])
    jp, tp = _params(jcfg, tcfg)
    rng = np.random.default_rng(6)
    x1 = rng.normal(size=(2, 1, 64)).astype(np.float32)
    kv = {k: rng.normal(size=(2, 12, 2, 16)).astype(np.float32)
          for k in ("k", "v")}
    jxattn = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"])["l0"]["xattn"]
    ref, _ = jlayers.attention_decode(
        jcfg, jxattn, jnp.asarray(x1), None, jnp.zeros(2, jnp.int32),
        cross_kv={k: jnp.asarray(v) for k, v in kv.items()})
    cache = {"untouched": torch.ones(1)}
    got, same = layers.attention_decode(
        tcfg, tp["blocks"][0]["l0"]["xattn"], torch.from_numpy(x1), cache,
        torch.zeros(2, dtype=torch.long),
        cross_kv={k: torch.from_numpy(v) for k, v in kv.items()})
    assert same is cache and torch.equal(cache["untouched"], torch.ones(1))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_attention_plain_without_rope_matches_reference():
    jcfg, tcfg = _cfgs(*CASES["dense_gqa"][:4])
    jp, tp = _params(jcfg, tcfg)
    x = np.random.default_rng(7).normal(size=(2, 9, 64)).astype(np.float32)
    jattn = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"])["l0"]["attn"]
    for causal in (False, True):
        ref = jlayers.attention_plain(jcfg, jattn, jnp.asarray(x),
                                      causal=causal, rope=False)
        got = layers.attention_plain(tcfg, tp["blocks"][0]["l0"]["attn"],
                                     torch.from_numpy(x), causal=causal,
                                     rope=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


# -------------------------------------------------- layouts and caches
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "whisper-base",
                                  "falcon-mamba-7b", "mixtral-8x22b"])
def test_make_cache_and_init_match_reference_layout(arch):
    from repro.configs import smoke_config as jsmoke
    jcfg, tcfg = jsmoke(arch), smoke_config(arch)
    ref = jax.tree_util.tree_map(np.asarray, jlm.make_cache(jcfg, 3, 40))
    got = lm.make_cache(tcfg, 3, 40, device="cpu")
    assert len(got) == tcfg.n_superblocks
    for name, entry in ref.items():
        assert got[0][name].keys() == entry.keys(), name
        for k, a in entry.items():
            t = got[0][name][k]
            assert tuple(t.shape) == a.shape[1:], (name, k)
            assert str(t.dtype).endswith(str(a.dtype)), (name, k)
    # init_params: the reference's tree, names, shapes and dtypes, in bf16
    jb, tb = jcfg.replace(dtype="bfloat16"), tcfg.replace(dtype="bfloat16")
    rtree = jax.tree_util.tree_map(np.asarray,
                                   jlm.init_params(jb, jax.random.key(0)))
    want = dict(_flatten(lm.params_from_jax(tb, rtree, device="cpu")))
    have = dict(_flatten(lm.init_params(tb, torch.Generator().manual_seed(0),
                                        device="cpu")))
    assert have.keys() == want.keys()
    for k in want:
        assert have[k].shape == want[k].shape, k
        assert have[k].dtype == want[k].dtype, k


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_cache_from_jax_carries_mamba_and_cross_entries():
    for arch in ("jamba-v0.1-52b", "whisper-base"):
        from repro.configs import smoke_config as jsmoke
        rng = np.random.default_rng(8)
        tree = jax.tree_util.tree_map(
            lambda a: rng.normal(size=a.shape).astype(np.float32),
            jlm.make_cache(jsmoke(arch), 2, 24))
        got = lm.cache_from_jax(smoke_config(arch), tree, device="cpu")
        _assert_cache_close(got, tree, 0)


# ------------------------------------------- the reference's behaviours
def _jamba_pair(**over):
    from repro.configs import smoke_config as jsmoke
    jcfg = jsmoke("jamba-v0.1-52b").replace(**over)
    tcfg = smoke_config("jamba-v0.1-52b").replace(**over)
    jp, tp = _params(jcfg, tcfg)
    return jcfg, jp, tcfg, tp


def test_mamba_state_absorbs_right_padding_in_both_packages():
    """A right-padded prompt's prefill scans its pads into the Mamba
    state, so decoding it from pos = len differs from decoding it alone;
    its last-position hidden state does not (the scan is causal).  The
    port does what the reference does (ROADMAP.md queue 3).  Capacity
    factor 8 drops no MoE slot, so the bucket's capacity plays no part."""
    jcfg, jp, tcfg, tp = _jamba_pair(capacity_factor=8.0)
    prompt = np.random.default_rng(9).integers(8, 512, 13).astype(np.int32)
    alone = prompt[None]
    padded = np.concatenate([prompt, np.zeros(19, np.int32)])[None]
    lens = np.array([13], np.int32)
    runs = {}
    for name, toks in (("alone", alone), ("padded", padded)):
        _, jcache, _ = jlm.prefill(jcfg, jp, jnp.asarray(toks), max_len=40)
        _, cache, _ = lm.prefill(tcfg, tp, torch.from_numpy(toks).long(),
                                 max_len=40)
        _assert_cache_close(cache, jcache, CACHE_TOL)
        tok = np.array([7], np.int32)
        ref, _ = jlm.decode_step(jcfg, jp, jcache, jnp.asarray(tok),
                                 jnp.asarray(lens))
        got, _ = lm.decode_step(tcfg, tp, cache, torch.from_numpy(tok).long(),
                                torch.from_numpy(lens).long())
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                                   atol=TOL)
        sel = lm.first_logits_select(tcfg, tp, torch.from_numpy(toks).long(),
                                     torch.from_numpy(lens).long(),
                                     torch.tensor([3, 4]))
        runs[name] = (got, cache[0]["l0"]["h"], sel)
    (d_a, h_a, s_a), (d_p, h_p, s_p) = runs["alone"], runs["padded"]
    assert (h_a - h_p).abs().max() > 1e-3       # the pads are in the state
    assert (d_a - d_p).abs().max() > 1e-3       # and so in the decode
    np.testing.assert_allclose(s_a.numpy(), s_p.numpy(), rtol=TOL, atol=TOL)


def test_moe_capacity_depends_on_the_bucket_in_both_packages():
    """C grows with the padded length T, so one prompt's logits differ
    between the 32 and 64 buckets; the pads themselves rank after the
    prompt's own tokens and evict none (any pad id gives the same
    logits).  Capacity factor 0.5 makes the 32 bucket drop tokens."""
    jcfg, jp, tcfg, tp = _jamba_pair(capacity_factor=0.5)
    prompt = np.random.default_rng(10).integers(8, 512, 20).astype(np.int32)
    lens, tids = np.array([20], np.int32), np.array([3, 4], np.int32)
    out = {}
    for bucket, pad in ((32, 0), (64, 0), (32, 5)):
        toks = np.concatenate([prompt, np.full(bucket - 20, pad, np.int32)])
        ref = jlm.first_logits_select(jcfg, jp, jnp.asarray(toks[None]),
                                      jnp.asarray(lens), jnp.asarray(tids))
        got = lm.first_logits_select(tcfg, tp,
                                     torch.from_numpy(toks[None]).long(),
                                     torch.from_numpy(lens).long(),
                                     torch.from_numpy(tids).long())
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                                   atol=TOL)
        out[bucket, pad] = got
    assert (out[32, 0] - out[64, 0]).abs().max() > 1e-4
    np.testing.assert_allclose(out[32, 0].numpy(), out[32, 5].numpy(),
                               rtol=1e-6, atol=1e-6)


def test_aux_is_the_sum_of_the_moe_layers():
    """forward's aux adds each MoE layer's Switch loss; no MoE: zero."""
    jcfg, jp, tcfg, tp = _jamba_pair()
    toks = np.random.default_rng(11).integers(0, 512, (2, 16))
    _, aux = lm.forward(tcfg, tp, torch.from_numpy(toks))
    _, ref = jlm.forward(jcfg, jp, jnp.asarray(toks, jnp.int32))
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(ref), rtol=AUX_RTOL)
    dense = smoke_config("llama3.1-8b")
    params = lm.init_params(dense, torch.Generator().manual_seed(0),
                            device="cpu")
    _, aux = lm.forward(dense, params, torch.from_numpy(toks))
    assert float(aux) == 0.0 and aux.dtype == torch.float32


def test_configs_are_the_reference_configs():
    from repro.configs import get_config as jget
    from repro.configs import smoke_config as jsmoke
    from repro_torch.configs import get_config, list_archs
    for arch in list_archs():
        for j, t in ((jget(arch), get_config(arch)),
                     (jsmoke(arch), smoke_config(arch))):
            assert dataclasses.asdict(t) == dataclasses.asdict(j), arch
            assert t.param_count() == j.param_count(), arch
