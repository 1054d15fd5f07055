"""The PyTorch port's decode leg against the JAX reference, on the CPU.

K5's plain version against the reference's plain version and its Pallas
kernel in interpret mode; ``attention_decode`` (global and ring-buffer
layers), ``prefill`` caches, ``decode_step`` logits and
``ServingEngine.generate`` token streams against the reference's, from the
same numpy inputs and the same weights (the reference's ``init_params``
tree through ``params_from_jax``).  On the card (marked ``cuda``): K5
against its plain version.  The reference is imported inside the ``jx``
fixture, so the ``cuda`` tests also run where JAX is not installed:

    python -m pytest tests/test_torch_decode.py -m cuda
"""
import functools
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.models import layers, lm
from repro_torch.serving import ServingEngine

ARCHS = ["llama3.1-8b", "qwen1.5-0.5b", "gemma3-12b"]
IMPLS = ["plain", "flash", "flash-ref"]
# the reference's decode-kernel test shapes (tests/test_kernels.py:95-103)
DECODE_CASES = [(2, 4, 2, 128, 64), (3, 8, 2, 300, 64), (1, 4, 4, 77, 128)]
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def jx():
    """The JAX reference: jnp, the decode kernel, layers, lm, engine."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.configs import smoke_config as jsmoke
    from repro.kernels.decode_attention.kernel import decode_attention_pallas
    from repro.kernels.decode_attention.ref import decode_attention_ref
    from repro.models import layers as jlayers
    from repro.models import lm as jlm
    from repro.serving.engine import ServingEngine as JServingEngine
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, smoke=jsmoke, decode_pallas=decode_attention_pallas,
        decode_ref=decode_attention_ref, layers=jlayers, lm=jlm,
        Engine=JServingEngine)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _decode_inputs(B, H, KV, L, hd, seed=0):
    rng = np.random.default_rng(seed + B * H * L + hd)
    lens = rng.integers(1, L + 1, B)
    lens[0] = 1  # the shortest row the decode path gives the kernel
    if B > 1:
        lens[-1] = L
    return (rng.normal(size=(B, H, hd)).astype(np.float32),
            rng.normal(size=(B, KV, L, hd)).astype(np.float32),
            rng.normal(size=(B, KV, L, hd)).astype(np.float32),
            lens.astype(np.int32))


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


# ------------------------------------------------------------------ K5
@pytest.mark.parametrize("B,H,KV,L,hd", DECODE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_ref_matches_reference(jx, B, H, KV, L, hd, dtype):
    q, k, v, lens = _decode_inputs(B, H, KV, L, hd)
    pt = _np(decode_attention_ref(
        *(torch.from_numpy(a).to(TORCH_DTYPES[dtype]) for a in (q, k, v)),
        torch.from_numpy(lens)))
    qj, kj, vj = (jx.jnp.asarray(a).astype(dtype) for a in (q, k, v))
    lj = jx.jnp.asarray(lens)
    tol = 2e-4 if dtype == "float32" else 2e-2
    for ref in (jx.decode_ref(qj, kj, vj, lj),
                jx.decode_pallas(qj, kj, vj, lj, block_l=64, interpret=True)):
        np.testing.assert_allclose(pt, _np(ref), rtol=tol, atol=tol)


def test_decode_attention_ref_takes_permuted_cache_views():
    """The model hands K5 its (B, L, KV, hd) cache permuted, with no copy."""
    q, k, v, lens = _decode_inputs(3, 8, 2, 40, 16)
    kc = torch.from_numpy(k).permute(0, 2, 1, 3).contiguous()  # (B,L,KV,hd)
    vc = torch.from_numpy(v).permute(0, 2, 1, 3).contiguous()
    got = decode_attention_ref(torch.from_numpy(q), kc.permute(0, 2, 1, 3),
                               vc.permute(0, 2, 1, 3), torch.from_numpy(lens))
    want = decode_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                torch.from_numpy(lens))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_version():
    q, k, v, lens = (torch.from_numpy(a) for a in _decode_inputs(2, 4, 2, 9, 16))
    before = decode_attention_cuda.launches
    torch.testing.assert_close(decode_ops.decode_attention(q, k, v, lens),
                               decode_attention_ref(q, k, v, lens))
    assert decode_attention_cuda.launches == before


def test_decode_wrapper_refuses_cpu_tensors():
    z = torch.zeros(1, 1, 4, 16)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_cuda(z[:, :, 0], z, z, torch.ones(1, dtype=torch.int32))


def test_decode_ops_rejects_unknown_impl():
    z = torch.zeros(1, 1, 4, 16)
    with pytest.raises(ValueError, match="impl"):
        decode_ops.decode_attention(z[:, :, 0], z, z, torch.ones(1),
                                    impl="pallas")


# ------------------------------------------------------ model weights
@functools.lru_cache(maxsize=None)
def _jax_tree(arch: str):
    """Reference weights; QKV biases get random values so they matter."""
    import jax
    from repro.configs import smoke_config as jsmoke
    from repro.models import lm as jlm
    tree = jax.tree_util.tree_map(
        np.asarray, jlm.init_params(jsmoke(arch), jax.random.key(0)))
    rng = np.random.default_rng(1)
    attn = tree["blocks"]["l0"]["attn"]
    for name in ("bq", "bk", "bv"):
        if name in attn:
            attn[name] = (0.1 * rng.normal(size=attn[name].shape)
                          ).astype(attn[name].dtype)
    return tree


def _pair(jx, arch, impl):
    jcfg = jx.smoke(arch).replace(attn_impl=impl)
    tcfg = smoke_config(arch).replace(attn_impl=impl)
    tree = _jax_tree(arch)
    jparams = jx.jax.tree_util.tree_map(jx.jnp.asarray, tree)
    return jcfg, jparams, tcfg, lm.params_from_jax(tcfg, tree, device="cpu")


def _stack_cache(cache):
    """The port's per-superblock cache as the reference's stacked numpy."""
    return {name: {kv: np.stack([sb[name][kv].float().numpy()
                                 for sb in cache]) for kv in ("k", "v")}
            for name in cache[0]}


def _assert_cache_close(got, ref, tol):
    got = _stack_cache(got)
    assert got.keys() == ref.keys()
    for name in ref:
        for kv in ("k", "v"):
            np.testing.assert_allclose(got[name][kv],
                                       np.asarray(ref[name][kv], np.float32),
                                       rtol=tol, atol=tol, err_msg=name + kv)


def test_make_cache_matches_reference_layout(jx):
    for arch in ARCHS:
        jcfg = jx.smoke(arch)
        ref = jx.lm.make_cache(jcfg, 3, 40)
        got = lm.make_cache(smoke_config(arch), 3, 40, device="cpu")
        assert len(got) == jcfg.n_superblocks
        for name, entry in ref.items():
            for kv in ("k", "v"):
                assert tuple(got[0][name][kv].shape) == entry[kv].shape[1:]
                assert str(got[0][name][kv].dtype).endswith(
                    str(entry[kv].dtype))
    # gemma's smoke ring: window 16 on five layers, the full length on one
    got = lm.make_cache(smoke_config("gemma3-12b"), 2, 40, device="cpu")[0]
    assert [got[f"l{i}"]["k"].shape[1] for i in range(6)] == [16] * 5 + [40]


def test_cache_from_jax_round_trips(jx):
    jcfg = jx.smoke("gemma3-12b")
    rng = np.random.default_rng(0)
    tree = jx.jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32),
        jx.lm.make_cache(jcfg, 2, 24))
    got = lm.cache_from_jax(smoke_config("gemma3-12b"), tree, device="cpu")
    _assert_cache_close(got, tree, 0)


# --------------------------------------------------- attention_decode
DECODE_LAYER_CASES = [
    # (arch, impl, layer index in the pattern): global layers on the plain
    # path and on K5 (flash), and gemma's ring buffer (window 16)
    ("llama3.1-8b", "plain", 0), ("llama3.1-8b", "flash", 0),
    ("llama3.1-8b", "flash-ref", 0), ("qwen1.5-0.5b", "flash", 0),
    ("gemma3-12b", "flash", 5), ("gemma3-12b", "plain", 0),
    ("gemma3-12b", "flash", 0)]


@pytest.mark.parametrize("arch,impl,layer", DECODE_LAYER_CASES)
def test_attention_decode_matches_reference(jx, arch, impl, layer):
    jcfg, jparams, tcfg, tparams = _pair(jx, arch, impl)
    spec = tcfg.pattern[layer]
    B, KV, hd = 3, tcfg.n_kv_heads, tcfg.resolved_head_dim
    L = lm._ring_len(tcfg, spec, 40)
    rng = np.random.default_rng(layer)
    x = rng.normal(size=(B, 1, tcfg.d_model)).astype(np.float32)
    kc, vc = (rng.normal(size=(B, L, KV, hd)).astype(np.float32)
              for _ in range(2))
    # ragged positions; the ring case runs past its window (16) and wraps
    pos = np.array([0, 9, 33] if spec.window else [0, 9, L - 1], np.int32)
    p = jparams["blocks"][f"l{layer}"]["attn"]
    jp = jx.jax.tree_util.tree_map(lambda a: a[0], p)
    ref_out, ref_cache = jx.layers.attention_decode(
        jcfg, jp, jx.jnp.asarray(x), {"k": jx.jnp.asarray(kc),
                                      "v": jx.jnp.asarray(vc)},
        jx.jnp.asarray(pos), window=spec.window)
    cache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
    out, got_cache = layers.attention_decode(
        tcfg, tparams["blocks"][0][f"l{layer}"]["attn"], torch.from_numpy(x),
        cache, torch.from_numpy(pos).long(), window=spec.window)
    assert got_cache is cache  # updated in place
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=1e-5,
                               atol=1e-5)
    for kv in ("k", "v"):
        np.testing.assert_allclose(cache[kv].numpy(),
                                   np.asarray(ref_cache[kv]), rtol=1e-5,
                                   atol=1e-5)


def test_attention_decode_refuses_cross_attention(jx):
    """Cross-attention decode is served now (the encoder-decoder came with
    the model zoo): it reads the static K/V, refuses to touch the cache it
    is given, and equals the reference's cross branch."""
    jcfg, jparams, tcfg, tparams = _pair(jx, "llama3.1-8b", "flash")
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 1, tcfg.d_model)).astype(np.float32)
    kv = {k: rng.normal(size=(2, 9, tcfg.n_kv_heads, tcfg.resolved_head_dim)
                        ).astype(np.float32) for k in ("k", "v")}
    ref, _ = jx.layers.attention_decode(
        jcfg, jx.jax.tree_util.tree_map(lambda a: a[0],
                                        jparams["blocks"])["l0"]["attn"],
        jx.jnp.asarray(x), None, jx.jnp.zeros(2, jx.jnp.int32),
        cross_kv={k: jx.jnp.asarray(v) for k, v in kv.items()})
    cache = {"k": torch.zeros(2, 4, 2, 16)}
    out, same = layers.attention_decode(
        tcfg, tparams["blocks"][0]["l0"]["attn"], torch.from_numpy(x), cache,
        torch.zeros(2, dtype=torch.long),
        cross_kv={k: torch.from_numpy(v) for k, v in kv.items()})
    assert same is cache and not cache["k"].any()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------- prefill and decode
@pytest.mark.parametrize("impl", ["plain", "flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(jx, arch, impl):
    """Logits and caches; gemma's ring layers fold S = 32 into 16 slots."""
    jcfg, jparams, tcfg, tparams = _pair(jx, arch, impl)
    tokens = np.random.default_rng(3).integers(0, 512, (2, 32)).astype(np.int32)
    ref_logits, ref_cache, ref_pos = jx.lm.prefill(
        jcfg, jparams, jx.jnp.asarray(tokens), max_len=40)
    logits, cache, pos = lm.prefill(tcfg, tparams,
                                    torch.from_numpy(tokens).long(), max_len=40)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(ref_pos))
    _assert_cache_close(cache, jx.jax.tree_util.tree_map(np.asarray,
                                                         ref_cache), 1e-5)
    last, _, _ = lm.prefill(tcfg, tparams, torch.from_numpy(tokens).long(),
                            max_len=40, last_only=True)
    np.testing.assert_allclose(last.numpy(), logits[:, -1].numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(jx, arch, impl):
    """Several steps from one prefill cache, with per-row positions, past
    gemma's window of 16."""
    jcfg, jparams, tcfg, tparams = _pair(jx, arch, impl)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, 512, (2, 16)).astype(np.int32)
    _, jcache, _ = jx.lm.prefill(jcfg, jparams, jx.jnp.asarray(tokens),
                                 max_len=24)
    cache = lm.cache_from_jax(tcfg, jx.jax.tree_util.tree_map(np.asarray,
                                                              jcache),
                              device="cpu")
    pos = np.array([16, 11], np.int32)
    for step in range(4):
        cur = rng.integers(0, 512, 2).astype(np.int32)
        ref, jcache = jx.lm.decode_step(jcfg, jparams, jcache,
                                        jx.jnp.asarray(cur),
                                        jx.jnp.asarray(pos))
        got, cache = lm.decode_step(tcfg, tparams, cache,
                                    torch.from_numpy(cur).long(),
                                    torch.from_numpy(pos).long())
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4, err_msg=f"step {step}")
        pos = pos + 1
    _assert_cache_close(cache, jx.jax.tree_util.tree_map(np.asarray, jcache),
                        1e-4)


# ---------------------------------------------------------- generate
def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, 45, n)  # the 32 and 64 buckets
    return [rng.integers(8, 512, int(k)).tolist() for k in lens]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_streams_match_reference(jx, arch, impl):
    jcfg, jparams, tcfg, tparams = _pair(jx, arch, impl)
    prompts = _prompts(5)
    jeng = jx.Engine(jcfg, jparams, max_batch=4)
    teng = ServingEngine(tcfg, tparams, max_batch=4, device="cpu")
    # 20 new tokens take gemma's ring (window 16) around more than once
    assert teng.generate(prompts, max_new=20) == jeng.generate(prompts,
                                                               max_new=20)
    assert teng.stats == jeng.stats


def test_generate_metrics_and_span_match_reference(jx):
    from repro.obs.trace import Tracer as JTracer
    from repro.obs.trace import use_tracer as juse
    from repro_torch.obs.trace import PORT_ONLY_KINDS, Tracer, use_tracer
    jcfg, jparams, tcfg, tparams = _pair(jx, "llama3.1-8b", "flash")
    prompts = _prompts(5, seed=1)
    jtr, ttr = JTracer(), Tracer()
    with juse(jtr):
        jx.Engine(jcfg, jparams, max_batch=4).generate(prompts, max_new=3)
    with use_tracer(ttr):
        ServingEngine(tcfg, tparams, max_batch=4, device="cpu").generate(
            prompts, max_new=3)
    spans = [[(s.kind, s.attrs) for s in tr.spans()
              if s.kind not in PORT_ONLY_KINDS] for tr in (jtr, ttr)]
    assert spans[0] == spans[1]
    assert all(a["phase"] == "generate" for _, a in spans[1])
    assert ttr.metrics.snapshot() == jtr.metrics.snapshot()
    assert ttr.metrics.snapshot()["engine.decode_tokens"] == 15


def test_generate_with_temperature_repeats_from_a_seeded_generator(jx):
    _, _, tcfg, tparams = _pair(jx, "llama3.1-8b", "flash")
    eng = ServingEngine(tcfg, tparams, max_batch=4, device="cpu")
    prompts = _prompts(5, seed=2)
    runs = [eng.generate(prompts, max_new=8, temperature=1.0,
                         generator=torch.Generator().manual_seed(seed))
            for seed in (7, 7, 8)]
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]
    assert runs[0] != eng.generate(prompts, max_new=8)  # not greedy
    with pytest.raises(ValueError, match="Generator"):
        eng.generate(prompts, max_new=2, temperature=1.0)


def test_generate_without_cuda_raises_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_config("llama3.1-8b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg, params).generate([[5, 6, 7]], max_new=2)
    out = ServingEngine(cfg, params, device="cpu").generate([[5, 6, 7]],
                                                            max_new=2)
    assert len(out) == 1 and len(out[0]) == 2


# ----------------------------------------------- CUDA kernel on the card
@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,L,hd", DECODE_CASES + [
    (2, 4, 2, 40, 16), (3, 4, 1, 130, 32), (2, 16, 8, 200, 256),
    (64, 32, 8, 128, 128), (1, 2, 2, 1, 64), (2, 16, 2, 100, 128),
    (3, 8, 1, 77, 64), (2, 16, 2, 40, 256), (2, 24, 2, 50, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["contiguous", "cache_view"])
def test_cuda_decode_attention_matches_plain(cuda, B, H, KV, L, hd, dtype,
                                             layout):
    q, k, v, lens = _decode_inputs(B, H, KV, L, hd)
    q, k, v = (torch.from_numpy(a).to(cuda, TORCH_DTYPES[dtype])
               for a in (q, k, v))
    if layout == "cache_view":  # the model's (B, L, KV, hd) cache, permuted
        k = k.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
        v = v.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    lens = torch.from_numpy(lens).to(cuda)
    before = decode_attention_cuda.launches
    got = decode_attention_cuda(q, k, v, lens)
    torch.cuda.synchronize()
    assert decode_attention_cuda.launches == before + 1
    tol = 2e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(),
                               decode_attention_ref(q, k, v, lens).float(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV", [(4, 4), (32, 8), (16, 2)])  # G 1, 4, 8
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_decode_attention_ragged_lengths(cuda, H, KV, hd, dtype):
    """Lengths of 1 and L, and lengths that end inside a warp's share of
    the slots, in the model's permuted cache view."""
    lens = [1, 128, 17, 33, 47, 63, 65, 100, 127, 2]
    B, L = len(lens), 128
    q, k, v, _ = _decode_inputs(B, H, KV, L, hd, seed=5)
    q, k, v = (torch.from_numpy(a).to(cuda, TORCH_DTYPES[dtype])
               for a in (q, k, v))
    k, v = (t.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
            for t in (k, v))
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    tol = 2e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(decode_attention_cuda(q, k, v, lens).float(),
                               decode_attention_ref(q, k, v, lens).float(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cuda_decode_attention_empty_rows_average_like_plain(cuda):
    """lengths <= 0 or > L: the plain version's uniform average / full row."""
    q, k, v, _ = _decode_inputs(3, 4, 2, 70, 64)
    q, k, v = (torch.from_numpy(a).to(cuda) for a in (q, k, v))
    lens = torch.tensor([0, 71, -3], dtype=torch.int32, device=cuda)
    torch.testing.assert_close(decode_attention_cuda(q, k, v, lens),
                               decode_attention_ref(q, k, v, lens),
                               rtol=2e-4, atol=2e-4)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.cuda
def test_cuda_generate_matches_the_cpu(cuda):
    """f32 smoke llama: K5 on the card gives the CPU's greedy stream."""
    cfg = smoke_config("llama3.1-8b").replace(attn_impl="flash")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    prompts = _prompts(5)
    cpu = ServingEngine(cfg, params, max_batch=4, device="cpu")
    want = cpu.generate(prompts, max_new=12)
    before = decode_attention_cuda.launches
    got = ServingEngine(cfg, _to(params, cuda), max_batch=4).generate(
        prompts, max_new=12)
    assert got == want
    batches = len(list(cpu.batcher.plan(prompts)))
    assert decode_attention_cuda.launches - before == \
        cfg.n_layers * 12 * batches
