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
from repro_torch.kernels.selective_scan import ops as scan_ops
from repro_torch.kernels.selective_scan.kernel import selective_scan_cuda
from repro_torch.kernels.selective_scan.ref import selective_scan_ref
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


# ------------------------------------------------------------------ K6
def _scan_inputs(Bt, S, di, dtype, given, seed=0):
    """K6's inputs as Jamba's layer makes them: A_log = log(1..16) a
    channel, dt = softplus(N(0, 1) - 4.6) (dt_bias -4.6), x = silu of a
    normal and z normal in ``dtype``, B, C normal, D near 1; h0 normal
    where ``given``.  Numpy-drawn, on the CPU."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(
        rng.normal(size=shape).astype(np.float32))
    x = torch.nn.functional.silu(f(Bt, S, di)).to(TORCH_DTYPES[dtype])
    dt = torch.nn.functional.softplus(f(Bt, S, di) - 4.6)
    A = -torch.arange(1, 17, dtype=torch.float32).log().exp().expand(
        di, 16).contiguous()
    return (x, dt, f(Bt, S, 16), f(Bt, S, 16),
            f(Bt, S, di).to(TORCH_DTYPES[dtype]), A, 1 + 0.1 * f(di),
            f(Bt, di, 16) if given else None)


@pytest.mark.parametrize("S", [1, 17, 40])
@pytest.mark.parametrize("given", [False, True], ids=["zeros", "h0"])
def test_selective_scan_plain_is_the_recurrence(S, given):
    """``ops.selective_scan`` on the CPU (the plain version, in chunks of
    16 with a tail) against the recurrence written out a step at a time
    in float64: y and the final state, within float32's rounding over
    40 steps."""
    x, dt, B, C, z, A, D, h0 = _scan_inputs(3, S, 24, "float32", given)
    y, h_last = scan_ops.selective_scan(x, dt, B, C, z, A, D, h0, chunk=16)
    d = lambda t: t.double()
    h = torch.zeros(3, 24, 16, dtype=torch.float64) if h0 is None else d(h0)
    want = []
    for t in range(S):
        h = torch.exp(d(dt[:, t, :, None]) * d(A)) * h \
            + (d(dt[:, t]) * d(x[:, t]))[..., None] * d(B[:, t, None, :])
        yt = torch.einsum("bds,bs->bd", h, d(C[:, t])) + d(D) * d(x[:, t])
        want.append(yt * torch.nn.functional.silu(d(z[:, t])))
    assert y.dtype == x.dtype and h_last.dtype == torch.float32
    torch.testing.assert_close(y.double(), torch.stack(want, 1), rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(h_last.double(), h, rtol=1e-5, atol=1e-6)


def test_selective_scan_wrapper_refuses_other_state_sizes():
    """K6 holds 16 states a channel in registers: any other d_state is
    refused before the device check and before anything launches."""
    x, dt, B, C, z, A, D, _ = _scan_inputs(1, 4, 8, "float32", False)
    before = selective_scan_cuda.launches
    for n in (8, 32):
        with pytest.raises(ValueError, match="d_state"):
            selective_scan_cuda(x, dt, B[..., :1].expand(1, 4, n),
                                C[..., :1].expand(1, 4, n), z,
                                A[:, :1].expand(8, n), D)
    assert selective_scan_cuda.launches == before


# ------------------------------------------------------------ dispatch
def test_cpu_tensors_take_the_plain_versions():
    """A CPU tensor goes to the plain version and launches nothing."""
    x = torch.randn(40, 8)
    before = (assign_clusters_cuda.launches, simvote_scores_cuda.launches,
              simvote_scores_segmented_cuda.launches,
              flash_attention_cuda.launches, selective_scan_cuda.launches)
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
    scan = _scan_inputs(2, 5, 8, "bfloat16", True)
    for got, want in zip(scan_ops.selective_scan(*scan),
                         selective_scan_ref(*scan)):
        torch.testing.assert_close(got, want)
    after = (assign_clusters_cuda.launches, simvote_scores_cuda.launches,
             simvote_scores_segmented_cuda.launches,
             flash_attention_cuda.launches, selective_scan_cuda.launches)
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
    lambda: selective_scan_cuda(*_scan_inputs(1, 4, 8, "bfloat16", True)),
], ids=["kmeans", "simvote", "simvote_segmented", "flash", "selective_scan"])
def test_cuda_wrappers_refuse_cpu_tensors(call):
    """The kernel wrappers never fall back: a CPU tensor raises."""
    with pytest.raises(ValueError, match="CUDA"):
        call()


def test_flash_wrapper_refuses_a_strided_head_dim():
    """hd must be at stride 1: refused before the device check and before
    anything launches."""
    q = torch.zeros(1, 2, 4, 32)[..., ::2]  # hd 16 at stride 2
    k = torch.zeros(1, 1, 4, 16)
    before = flash_attention_cuda.launches
    with pytest.raises(ValueError, match="stride 1"):
        flash_attention_cuda(q, k, k)
    with pytest.raises(ValueError, match="stride 1"):
        flash_attention_cuda(k, q[:, :1], k)
    assert flash_attention_cuda.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vector_access_check_takes_aligned_views(dtype):
    """The 16-byte kernels take the model's views and refuse rows that do
    not start on 16 bytes."""
    from repro_torch.kernels import build
    seq_major = torch.zeros(2, 5, 4, 32, dtype=dtype).transpose(1, 2)
    cache_view = torch.zeros(2, 7, 4, 16, dtype=dtype).permute(0, 2, 1, 3)
    build.require_vector_access("k", seq_major, cache_view,
                                seq_major[:1, :1])
    wide = torch.zeros(2, 4, 40, dtype=dtype)
    with pytest.raises(ValueError, match="16-byte"):
        build.require_vector_access("k", wide[..., 1:33])  # rows off 16 B
    with pytest.raises(ValueError, match="16-byte"):
        build.require_vector_access("k", wide[..., ::2])


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


# the served record shape (one oracle batch of llama3.1-8b) at both
# buckets, and G = 8 and 16 beside the 1, 2 and 4 of the cases above (at
# G = 16 a q tile is 8 positions and a warp's 16 rows span two heads)
FLASH_CUDA_CASES = FLASH_CASES + [
    (2, 4, 2, 64, 16), (1, 4, 2, 96, 32), (2, 8, 2, 128, 256),
    (4, 32, 8, 64, 128), (1, 2, 1, 200, 64), (2, 16, 2, 64, 64),
    (1, 8, 1, 96, 128), (1, 16, 1, 72, 64), (64, 32, 8, 32, 128),
    (64, 32, 8, 64, 128)]


def _seq_major(a: torch.Tensor) -> torch.Tensor:
    """The same values as a (B, heads, S, hd) view of a (B, S, heads, hd)
    tensor, as ``layers.attention_flash`` passes its projections."""
    return a.transpose(1, 2).contiguous().transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,S,hd", FLASH_CUDA_CASES)
@pytest.mark.parametrize("window", [None, 64, 17])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["contiguous", "seq_major"])
def test_cuda_flash_attention_matches_plain(cuda, B, H, KV, S, hd, window,
                                            dtype, layout):
    q, k, v = (_torch(a, dtype).to(cuda) for a in _qkv(B, H, KV, S, hd))
    if layout == "seq_major":
        q, k, v = (_seq_major(t) for t in (q, k, v))
        assert not q.is_contiguous() and q.stride(-1) == 1
    tol = 2e-4 if dtype == "float32" else 2e-2
    before = flash_attention_cuda.launches
    got = flash_attention_cuda(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    # the output lies as (B, S, H, hd): the model's reshape is a view
    assert got.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(
        got.float(),
        flash_attention_ref(q, k, v, causal=True, window=window).float(),
        rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_attention_non_causal_matches_plain(cuda, dtype):
    q, k, v = (_seq_major(_torch(a, dtype).to(cuda))
               for a in _qkv(2, 8, 2, 80, 64))
    tol = 2e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(
        flash_attention_cuda(q, k, v, causal=False).float(),
        flash_attention_ref(q, k, v, causal=False).float(),
        rtol=tol, atol=tol)


# K6 at the engine's batch (B 64, d_inner 8,192) at the buckets S 32 and
# 64 from zeros, and at S 1, 17 (a partial tile and group) and 300 (ten
# tiles, the last partial) from a given state
SCAN_CUDA_CASES = [(32, False), (64, False), (1, True), (17, True),
                   (300, True)]


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One unit in the last place of bfloat16 at each value of ``t``
    (8 significant bits)."""
    _, e = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


@pytest.mark.cuda
@pytest.mark.parametrize("S,given", SCAN_CUDA_CASES)
def test_cuda_selective_scan_matches_plain(cuda, S, given):
    x, dt, B, C, z, A, D, h0 = (
        None if t is None else t.to(cuda)
        for t in _scan_inputs(64, S, 8192, "bfloat16", given))
    B, C = (torch.cat([B, C, B], -1)[..., i * 16:(i + 1) * 16]
            for i in (0, 1))  # views of one product, as the gates split
    before = selective_scan_cuda.launches
    y, h_last = selective_scan_cuda(x, dt, B, C, z, A, D, h0)
    torch.cuda.synchronize()
    assert selective_scan_cuda.launches == before + 1
    want_y, want_h = selective_scan_ref(x, dt, B, C, z, A, D, h0, chunk=64)
    torch.cuda.synchronize()
    # the state: float32 with the plain version's operations in its
    # order along t, the decay from exp2f a few units in the last place
    # off torch.exp; the scale term admits elements that cancel near 0
    torch.testing.assert_close(h_last, want_h, rtol=1e-5,
                               atol=1e-5 * want_h.abs().max().item())
    # y: the 16-term read-out may sum in another order, which can move
    # the bfloat16 rounding of the gated output by one unit; where the
    # read-out cancels to near 0, its float32 rounding (within 2^-23 of
    # the largest output, measured on the card) can exceed a unit of the
    # tiny result, so that much is allowed beside it
    assert y.dtype == torch.bfloat16
    diff = (y.float() - want_y.float()).abs()
    floor = 2.0 ** -20 * want_y.float().abs().max()
    assert (diff <= torch.maximum(_bf16_ulp(y), _bf16_ulp(want_y))
            .clamp(min=floor)).all()
