"""The port's embedding encoder against the JAX reference, on the CPU.

``encoder_forward`` on the ``e5-large`` smoke config within 1e-5 of the
reference's, with the reference's ``init_encoder_params`` tree carried
across by ``lm.encoder_params_from_jax``; ``EmbeddingModel.encode`` over
texts longer than ``max_len`` (several chunks, mean merge); and a
``Session`` whose embedder is the encoder, over a text-only table, giving
the reference's mask, calls and ``cluster_log``.  On the card (marked
``cuda``): the encoder against itself on the CPU.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.api import ExecutionPolicy, Session
from repro_torch.configs import smoke_config
from repro_torch.core.oracle import SyntheticOracle
from repro_torch.data import make_dataset
from repro_torch.embeddings import EmbeddingModel, encode_texts
from repro_torch.embeddings.encoder import encoder_forward, init_encoder_params
from repro_torch.models import lm

N = 400


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import types

    import jax
    import jax.numpy as jnp

    from repro import api as japi
    from repro.configs import smoke_config as jsmoke
    from repro.core.oracle import SyntheticOracle as JSyntheticOracle
    from repro.embeddings import encoder as jenc
    return types.SimpleNamespace(jax=jax, jnp=jnp, api=japi, smoke=jsmoke,
                                 enc=jenc, Oracle=JSyntheticOracle)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _tree():
    import jax
    from repro.configs import smoke_config as jsmoke
    from repro.embeddings import encoder as jenc
    return jax.tree_util.tree_map(
        np.asarray, jenc.init_encoder_params(jsmoke("e5-large"),
                                             jax.random.key(0)))


def _cfg():
    return smoke_config("e5-large")


def _params():
    return lm.encoder_params_from_jax(_cfg(), _tree(), device="cpu")


def _jparams(jx):
    return jx.jax.tree_util.tree_map(jx.jnp.asarray, _tree())


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


def test_init_encoder_params_has_the_reference_layout():
    """Names, shapes and types of the port's random weights equal the
    reference tree's, layer by layer."""
    got = _flat(init_encoder_params(_cfg(), torch.Generator().manual_seed(0),
                                    device="cpu"))
    ref = _tree()
    want = {}
    for key, a in _flat(ref).items():
        if key.startswith("/blocks/"):
            for i in range(a.shape[0]):
                want[f"/blocks/{i}" + key[len("/blocks"):]] = a[i]
        else:
            want[key] = a
    assert got.keys() == want.keys()
    for key, t in got.items():
        assert tuple(t.shape) == want[key].shape, key
        assert str(t.dtype).split(".")[1] == str(want[key].dtype), key


@pytest.mark.parametrize("B,S", [(3, 20), (2, 128)])
def test_encoder_forward_matches_reference(jx, B, S):
    rng = np.random.default_rng(B * S)
    toks = rng.integers(0, 512, (B, S)).astype(np.int32)
    mask = np.ones((B, S), bool)
    mask[0, S // 2:] = False   # padded rows pool over their real tokens
    mask[-1, 1:] = False
    ref = np.asarray(jx.enc.encoder_forward(jx.smoke("e5-large"),
                                            _jparams(jx), jx.jnp.asarray(toks),
                                            jx.jnp.asarray(mask)))
    got = encoder_forward(_cfg(), _params(), torch.from_numpy(toks).long(),
                          torch.from_numpy(mask)).numpy()
    assert got.dtype == np.float32 and got.shape == (B, 64)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_encode_long_texts_merges_chunks_like_reference(jx):
    """Texts of 1 to ~60 words at max_len 16: up to four chunks a text,
    one empty text, batches that split a text's chunks."""
    rng = np.random.default_rng(3)
    words = ["good", "bad", "film", "plot", "the", "acting", "dull", "!"]
    texts = [" ".join(rng.choice(words, int(n))) for n in
             rng.integers(1, 60, 11)] + [""]
    ref = jx.enc.EmbeddingModel(jx.smoke("e5-large"), params=_jparams(jx),
                                max_len=16).encode(texts, batch=5)
    model = EmbeddingModel(_cfg(), params=_params(), max_len=16,
                           device="cpu")
    got = model.encode(texts, batch=5)
    assert max(len(model.tok.encode(t)) for t in texts) > 3 * 16
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def _session_run(side, jx, ds):
    pol = dict(method="csv-sim", n_clusters=4)
    if side == "ref":
        model = jx.enc.EmbeddingModel(jx.smoke("e5-large"),
                                      params=_jparams(jx), max_len=32)
        sess = jx.api.Session(policy=jx.api.ExecutionPolicy(**pol),
                              embedder=model.encode)
        oracle = jx.Oracle(ds.labels["RV-Q1"], flip_prob=0.02, seed=7,
                           token_lens=ds.token_lens)
    else:
        model = EmbeddingModel(_cfg(), params=_params(), max_len=32,
                               device="cpu")
        sess = Session(policy=ExecutionPolicy(**pol), embedder=model.encode,
                       init_centroids=_jax_seeder(jx), device="cpu")
        oracle = SyntheticOracle(ds.labels["RV-Q1"], flip_prob=0.02, seed=7,
                                 token_lens=ds.token_lens)
    t = sess.table(texts=ds.texts, name="reviews")
    r = t.filter(oracle, name="q").collect()
    node = r.raw.results["q"]
    return r, node, np.asarray(t.embeddings)


@functools.lru_cache(maxsize=None)
def _plusplus():
    import jax
    from repro.core import clustering as jc
    return jax.jit(jc._plusplus_init, static_argnums=2)


def _jax_seeder(jx):
    def seeder(seed, x, k):
        return np.asarray(_plusplus()(jx.jax.random.key(seed),
                                      jx.jnp.asarray(x), k))
    return seeder


def test_embedder_session_on_text_only_table_matches_reference(jx):
    ds = make_dataset("imdb_review", n=N, dim=8, seed=0)
    r_ref, n_ref, e_ref = _session_run("ref", jx, ds)
    r, n, e = _session_run("port", jx, ds)
    np.testing.assert_allclose(e, e_ref, rtol=1e-5, atol=1e-5)
    assert r.n_llm_calls == r_ref.n_llm_calls > 0
    assert r.pilot_calls == r_ref.pilot_calls
    np.testing.assert_array_equal(r.mask, r_ref.mask)
    assert n.cluster_log == n_ref.cluster_log
    assert n.n_llm_calls == n_ref.n_llm_calls


def test_encode_texts_defaults_to_the_smoke_encoder():
    out = encode_texts(["a good film", "a bad film"], device="cpu")
    assert out.shape == (2, 64) and out.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-5)
    again = encode_texts(["a good film", "a bad film"], device="cpu")
    np.testing.assert_array_equal(out, again)   # seeded: repeatable


def test_encoder_and_decoder_configs_stay_apart():
    with pytest.raises(ValueError, match="not an encoder"):
        EmbeddingModel(smoke_config("llama3.1-8b"), device="cpu")
    with pytest.raises(ValueError, match="encoder"):
        lm.init_params(_cfg(), torch.Generator(), device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_cuda_encoder_matches_the_cpu(cuda, dtype, tol):
    """The smoke encoder on the card against itself on the CPU (f32: the
    same arithmetic in another order; bf16 against the f32 CPU run)."""
    cfg = _cfg()
    params = init_encoder_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    texts = [f"review {i} " + "good film " * (i % 40) for i in range(50)]
    want = EmbeddingModel(cfg, params=params, max_len=32,
                          device="cpu").encode(texts)
    dev_cfg = cfg.replace(dtype=dtype)
    # the same draws in the card's type (weights are drawn in f32 and cast)
    dev_params = _to(init_encoder_params(
        dev_cfg, torch.Generator().manual_seed(0), device="cpu"), cuda)
    got = EmbeddingModel(dev_cfg, params=dev_params, max_len=32).encode(texts)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)
