"""Kernel modules of the PyTorch port against the JAX reference.

On the CPU: each plain PyTorch version (``ref.py``) against the reference
``ref.py`` and the Pallas kernel in interpret mode, at the parametrisations
and tolerances of tests/test_kernels.py, with the same numpy inputs.
On the card (marked ``cuda``): each CUDA kernel against its plain version.
The reference is imported inside the ``jx`` fixture, so the ``cuda`` tests
also run where JAX is not installed:

    python -m pytest tests/test_torch_kernels.py -m cuda
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.kmeans import ops as kmeans_ops
from repro_torch.kernels.kmeans.kernel import assign_clusters_cuda
from repro_torch.kernels.kmeans.ref import assign_clusters_ref
from repro_torch.kernels.simvote import ops as simvote_ops
from repro_torch.kernels.simvote.kernel import (simvote_scores_cuda,
                                                simvote_scores_segmented_cuda)
from repro_torch.kernels.simvote.ref import (simvote_scores_ref,
                                             simvote_scores_segmented_ref)

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def jx():
    """The JAX reference kernels and their plain versions."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels.flash_attention.kernel import flash_attention_pallas
    from repro.kernels.flash_attention.ref import flash_attention_ref
    from repro.kernels.kmeans.kernel import assign_clusters_pallas
    from repro.kernels.kmeans.ref import assign_clusters_ref
    from repro.kernels.simvote.kernel import (simvote_scores_pallas,
                                              simvote_scores_segmented_pallas)
    from repro.kernels.simvote.ref import (simvote_scores_ref,
                                           simvote_scores_segmented_ref)
    return types.SimpleNamespace(
        jnp=jnp, flash_pallas=flash_attention_pallas,
        flash_ref=flash_attention_ref, assign_pallas=assign_clusters_pallas,
        assign_ref=assign_clusters_ref, simvote_pallas=simvote_scores_pallas,
        simvote_seg_pallas=simvote_scores_segmented_pallas,
        simvote_ref=simvote_scores_ref,
        simvote_seg_ref=simvote_scores_segmented_ref)


def _torch(a: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(a).to(TORCH_DTYPES[dtype])


def _jax(jx, a: np.ndarray, dtype: str):
    """The same values as ``_torch`` gives (both casts round to nearest)."""
    return jx.jnp.asarray(a).astype(dtype)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


# ------------------------------------------------------------------ K1
@pytest.mark.parametrize("n,d,k", [(100, 16, 3), (257, 64, 8), (512, 128, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kmeans_assign_ref_matches_reference(jx, n, d, k, dtype):
    rng = np.random.default_rng(n + d + k)
    x = rng.normal(size=(n, d)).astype(np.float32)
    c = rng.normal(size=(k, d)).astype(np.float32)
    a_pt, d_pt = assign_clusters_ref(_torch(x, dtype), _torch(c, dtype))
    xj, cj = _jax(jx, x, dtype), _jax(jx, c, dtype)
    tol = 1e-5 if dtype == "float32" else 5e-2
    for a_j, d_j in (jx.assign_ref(xj, cj),
                     jx.assign_pallas(xj, cj, block_n=128, interpret=True)):
        assert (a_pt.numpy() == np.asarray(a_j)).mean() > 0.999  # bf16 ties
        np.testing.assert_allclose(d_pt.numpy(), _np(d_j), rtol=tol, atol=tol)


# ------------------------------------------------------------------ K2
@pytest.mark.parametrize("n,m,d", [(64, 16, 8), (300, 77, 32), (500, 128, 64)])
def test_simvote_ref_matches_reference(jx, n, m, d):
    rng = np.random.default_rng(n + m + d)
    x = rng.normal(size=(n, d)).astype(np.float32)
    s = rng.normal(size=(m, d)).astype(np.float32)
    y = (rng.random(m) > 0.5).astype(np.float32)
    pt = simvote_scores_ref(torch.from_numpy(x), torch.from_numpy(s),
                            torch.from_numpy(y), 1.1).numpy()
    xj, sj, yj = (jx.jnp.asarray(a) for a in (x, s, y))
    for ref in (jx.simvote_ref(xj, sj, yj, 1.1),
                jx.simvote_pallas(xj, sj, yj, 1.1, block_n=64, block_m=32,
                                  interpret=True)):
        np.testing.assert_allclose(pt, np.asarray(ref), rtol=1e-5, atol=1e-6)
    assert (pt >= 0).all() and (pt <= 1 + 1e-6).all()


# ------------------------------------------------------------------ K3
def _segmented_inputs(counts, ms, d=16):
    rng = np.random.default_rng(sum(counts))
    c, max_m = len(counts), max(ms)
    s_pad = np.zeros((c, max_m, d), np.float32)
    y_pad = -np.ones((c, max_m), np.float32)
    taus = rng.uniform(0.5, 2.0, c)
    xs = []
    for i in range(c):
        xs.append(rng.normal(size=(counts[i], d)).astype(np.float32))
        s_pad[i, :ms[i]] = rng.normal(size=(ms[i], d)).astype(np.float32)
        y_pad[i, :ms[i]] = (rng.random(ms[i]) < 0.5).astype(np.float32)
    return np.concatenate(xs), np.asarray(counts), s_pad, y_pad, taus


SEGMENTED_CASES = [([70, 3, 129, 40], [5, 17, 33, 2]), ([1, 256], [40, 1]),
                   ([300], [64])]


@pytest.mark.parametrize("counts,ms", SEGMENTED_CASES)
def test_simvote_segmented_ref_matches_reference(jx, counts, ms):
    x, counts, s_pad, y_pad, taus = _segmented_inputs(counts, ms)
    pt = simvote_scores_segmented_ref(
        torch.from_numpy(x), counts, torch.from_numpy(s_pad),
        torch.from_numpy(y_pad), taus).numpy()
    xj, sj, yj = (jx.jnp.asarray(a) for a in (x, s_pad, y_pad))
    ref = jx.simvote_seg_ref(xj, counts, sj, yj, taus)
    pal = jx.simvote_seg_pallas(xj, counts, sj, yj, taus, block_n=64,
                                block_m=16, interpret=True)
    np.testing.assert_allclose(pt, np.asarray(ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pt, np.asarray(pal), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ K4
FLASH_CASES = [(1, 4, 4, 128, 64), (2, 8, 2, 256, 64), (1, 4, 1, 128, 128)]


def _qkv(B, H, KV, S, hd):
    rng = np.random.default_rng(B * H * S + hd)
    return (rng.normal(size=(B, H, S, hd)).astype(np.float32),
            rng.normal(size=(B, KV, S, hd)).astype(np.float32),
            rng.normal(size=(B, KV, S, hd)).astype(np.float32))


@pytest.mark.parametrize("B,H,KV,S,hd", FLASH_CASES)
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_ref_matches_reference(jx, B, H, KV, S, hd, window,
                                               dtype):
    qkv = _qkv(B, H, KV, S, hd)
    pt = _np(flash_attention_ref(*(_torch(a, dtype) for a in qkv),
                                 causal=True, window=window))
    qj, kj, vj = (_jax(jx, a, dtype) for a in qkv)
    tol = 2e-4 if dtype == "float32" else 2e-2
    for ref in (jx.flash_ref(qj, kj, vj, causal=True, window=window),
                jx.flash_pallas(qj, kj, vj, causal=True, window=window,
                                block_q=64, block_k=64, interpret=True)):
        np.testing.assert_allclose(pt, _np(ref), rtol=tol, atol=tol)


# ------------------------------------------------------------ dispatch
def test_cpu_tensors_take_the_plain_versions():
    """A CPU tensor goes to the plain version and launches nothing."""
    x = torch.randn(40, 8)
    before = (assign_clusters_cuda.launches, simvote_scores_cuda.launches,
              simvote_scores_segmented_cuda.launches,
              flash_attention_cuda.launches)
    a, _ = kmeans_ops.assign_clusters(x, x[:3].contiguous())
    assert (a.numpy()[:3] == np.arange(3)).all()
    y = (torch.arange(5) % 2).float()
    torch.testing.assert_close(
        simvote_ops.simvote_scores(x, x[:5], y, 1.0),
        simvote_scores_ref(x, x[:5], y, 1.0))
    simvote_ops.simvote_scores_segmented(
        x, [30, 10], torch.stack([x[:5], x[5:10]]), torch.stack([y, y]),
        [1.0, 2.0])
    q = torch.randn(1, 2, 16, 16)
    torch.testing.assert_close(flash_ops.flash_attention(q, q[:, :1], q[:, :1]),
                               flash_attention_ref(q, q[:, :1], q[:, :1]))
    after = (assign_clusters_cuda.launches, simvote_scores_cuda.launches,
             simvote_scores_segmented_cuda.launches,
             flash_attention_cuda.launches)
    assert after == before


@pytest.mark.parametrize("call", [
    lambda: assign_clusters_cuda(torch.zeros(4, 2), torch.zeros(1, 2)),
    lambda: simvote_scores_cuda(torch.zeros(4, 2), torch.zeros(1, 2),
                                torch.zeros(1), 1.0),
    lambda: simvote_scores_segmented_cuda(torch.zeros(4, 2), [4],
                                          torch.zeros(1, 1, 2),
                                          torch.zeros(1, 1), [1.0]),
    lambda: flash_attention_cuda(torch.zeros(1, 1, 4, 16),
                                 torch.zeros(1, 1, 4, 16),
                                 torch.zeros(1, 1, 4, 16)),
], ids=["kmeans", "simvote", "simvote_segmented", "flash"])
def test_cuda_wrappers_refuse_cpu_tensors(call):
    """The kernel wrappers never fall back: a CPU tensor raises."""
    with pytest.raises(ValueError, match="CUDA"):
        call()


def test_flash_ops_rejects_unknown_impl():
    q = torch.zeros(1, 1, 4, 16)
    with pytest.raises(ValueError, match="impl"):
        flash_ops.flash_attention(q, q, q, impl="pallas")


# ----------------------------------------------- CUDA kernels on the card
@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", [(100, 16, 3), (257, 64, 8), (512, 128, 16),
                                   (2000, 1024, 4), (300, 200, 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kmeans_assign_matches_plain(cuda, n, d, k, dtype):
    rng = np.random.default_rng(n + d + k)
    x = _torch(rng.normal(size=(n, d)).astype(np.float32), dtype).to(cuda)
    c = _torch(rng.normal(size=(k, d)).astype(np.float32), dtype).to(cuda)
    a1, d1 = assign_clusters_cuda(x, c)
    a2, d2 = assign_clusters_ref(x, c)
    torch.cuda.synchronize()
    assert (a1 == a2).float().mean().item() >= 0.999
    tol = 1e-5 if dtype == "float32" else 5e-2
    torch.testing.assert_close(d1, d2, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,d", [(64, 16, 8), (300, 77, 32), (500, 128, 64),
                                   (1000, 101, 1024)])
def test_cuda_simvote_matches_plain(cuda, n, m, d):
    rng = np.random.default_rng(n + m + d)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(cuda)
    s = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).to(cuda)
    y = torch.from_numpy((rng.random(m) > 0.5).astype(np.float32)).to(cuda)
    tau = float(np.sqrt(d))
    torch.testing.assert_close(simvote_scores_cuda(x, s, y, tau),
                               simvote_scores_ref(x, s, y, tau),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("counts,ms", SEGMENTED_CASES + [([0, 5, 0], [3, 4, 1])])
def test_cuda_simvote_segmented_matches_plain(cuda, counts, ms):
    x, counts, s_pad, y_pad, taus = _segmented_inputs(counts, ms)
    args = (torch.from_numpy(x).to(cuda), counts,
            torch.from_numpy(s_pad).to(cuda), torch.from_numpy(y_pad).to(cuda),
            taus)
    torch.testing.assert_close(simvote_scores_segmented_cuda(*args),
                               simvote_scores_segmented_ref(*args),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,S,hd", FLASH_CASES + [
    (2, 4, 2, 64, 16), (1, 4, 2, 96, 32), (2, 8, 2, 128, 256),
    (4, 32, 8, 64, 128), (1, 2, 1, 200, 64)])
@pytest.mark.parametrize("window", [None, 64, 17])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_attention_matches_plain(cuda, B, H, KV, S, hd, window,
                                            dtype):
    q, k, v = (_torch(a, dtype).to(cuda) for a in _qkv(B, H, KV, S, hd))
    tol = 2e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(
        flash_attention_cuda(q, k, v, causal=True, window=window).float(),
        flash_attention_ref(q, k, v, causal=True, window=window).float(),
        rtol=tol, atol=tol)
