"""K1 (k-means assignment) and the SimVote kernel behind K2/K3 at the
shapes that reach every instantiation and edge of their CUDA kernels.

On the CPU: the plain versions against the JAX reference (its ``ref.py``
and the Pallas kernel in interpret mode) at K > 32, D not a multiple of 4
and M > 128, the wrappers' choice of instantiation and tile, and K1's
widest row.  On the
card (marked ``cuda``): each kernel against its plain version, with the
tolerances of tests/test_torch_kernels.py (K1 1e-5 f32 and 5e-2 bf16 with
assignments agreeing on >= 0.999; K2/K3 rtol 1e-5, atol 1e-6).  JAX is
imported inside the ``jx`` fixture, so the ``cuda`` tests run without it:

    python -m pytest tests/test_torch_kmeans_simvote.py -m cuda
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.kmeans import kernel as kmeans_kernel
from repro_torch.kernels.kmeans.kernel import assign_clusters_cuda
from repro_torch.kernels.kmeans.ref import assign_clusters_ref
from repro_torch.kernels.simvote import kernel as simvote_kernel
from repro_torch.kernels.simvote.kernel import (simvote_scores_cuda,
                                                simvote_scores_segmented_cuda)
from repro_torch.kernels.simvote.ref import (simvote_scores_ref,
                                             simvote_scores_segmented_ref)

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SIM_TOL = dict(rtol=1e-5, atol=1e-6)


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

    from repro.kernels.kmeans.kernel import assign_clusters_pallas
    from repro.kernels.kmeans.ref import assign_clusters_ref
    from repro.kernels.simvote.kernel import (simvote_scores_pallas,
                                              simvote_scores_segmented_pallas)
    from repro.kernels.simvote.ref import (simvote_scores_ref,
                                           simvote_scores_segmented_ref)
    return types.SimpleNamespace(
        jnp=jnp, assign_pallas=assign_clusters_pallas,
        assign_ref=assign_clusters_ref, simvote_pallas=simvote_scores_pallas,
        simvote_seg_pallas=simvote_scores_segmented_pallas,
        simvote_ref=simvote_scores_ref,
        simvote_seg_ref=simvote_scores_segmented_ref)


def _points(n, d, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(k, d)).astype(np.float32))


def _segmented_inputs(counts, ms, d, *, pad_labels=()):
    """Clusters of counts[i] rows and ms[i] samples, padded to max(ms);
    the clusters in ``pad_labels`` have every label set to -1."""
    rng = np.random.default_rng(sum(counts) + d)
    c, max_m = len(counts), max(ms)
    s_pad = np.zeros((c, max_m, d), np.float32)
    y_pad = -np.ones((c, max_m), np.float32)
    # tau near the rows' spread, so weights are neither all 1 nor all 0
    taus = rng.uniform(0.5, 1.0, c) * np.sqrt(d)
    xs = []
    for i in range(c):
        xs.append(rng.normal(size=(counts[i], d)).astype(np.float32))
        s_pad[i, :ms[i]] = rng.normal(size=(ms[i], d)).astype(np.float32)
        if i not in pad_labels:
            y_pad[i, :ms[i]] = (rng.random(ms[i]) < 0.5).astype(np.float32)
    return (np.concatenate(xs).reshape(-1, d), np.asarray(counts), s_pad,
            y_pad, taus)


# ------------------------------------------------- CPU: the plain versions
@pytest.mark.parametrize("n,d,k", [(200, 37, 33), (150, 1023, 40),
                                   (130, 64, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kmeans_assign_ref_matches_reference_wide(jx, n, d, k, dtype):
    x, c = _points(n, d, k, n + d + k)
    xt, ct = (torch.from_numpy(a).to(TORCH_DTYPES[dtype]) for a in (x, c))
    a_pt, d_pt = assign_clusters_ref(xt, ct)
    xj, cj = (jx.jnp.asarray(a).astype(dtype) for a in (x, c))
    tol = 1e-5 if dtype == "float32" else 5e-2
    for a_j, d_j in (jx.assign_ref(xj, cj),
                     jx.assign_pallas(xj, cj, block_n=128, interpret=True)):
        assert (a_pt.numpy() == np.asarray(a_j)).mean() > 0.999
        np.testing.assert_allclose(d_pt.numpy(),
                                   np.asarray(d_j, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("n,m,d", [(64, 129, 37), (100, 300, 1023)])
def test_simvote_ref_matches_reference_many_samples(jx, n, m, d):
    rng = np.random.default_rng(n + m + d)
    x = rng.normal(size=(n, d)).astype(np.float32)
    s = rng.normal(size=(m, d)).astype(np.float32)
    y = (rng.random(m) > 0.5).astype(np.float32)
    tau = float(np.sqrt(d))
    pt = simvote_scores_ref(*(torch.from_numpy(a) for a in (x, s, y)),
                            tau).numpy()
    xj, sj, yj = (jx.jnp.asarray(a) for a in (x, s, y))
    for ref in (jx.simvote_ref(xj, sj, yj, tau),
                jx.simvote_pallas(xj, sj, yj, tau, block_n=64, block_m=128,
                                  interpret=True)):
        np.testing.assert_allclose(pt, np.asarray(ref), **SIM_TOL)


@pytest.mark.parametrize("counts,ms,d", [
    ([40, 1, 70], [129, 300, 17], 37),
    ([90, 25], [300, 140], 1023),
    ([60, 33, 5], [101, 101, 101], 2048),  # the join's pair width, 2 x 1024
])
def test_simvote_segmented_ref_matches_reference_wide(jx, counts, ms, d):
    x, counts, s_pad, y_pad, taus = _segmented_inputs(counts, ms, d)
    pt = simvote_scores_segmented_ref(
        torch.from_numpy(x), counts, torch.from_numpy(s_pad),
        torch.from_numpy(y_pad), taus).numpy()
    xj, sj, yj = (jx.jnp.asarray(a) for a in (x, s_pad, y_pad))
    np.testing.assert_allclose(
        pt, np.asarray(jx.simvote_seg_ref(xj, counts, sj, yj, taus)),
        **SIM_TOL)
    np.testing.assert_allclose(
        pt, np.asarray(jx.simvote_seg_pallas(xj, counts, sj, yj, taus,
                                             block_n=128, block_m=128,
                                             interpret=True)), **SIM_TOL)


# ------------------------------------ CPU: instantiation and tile choice
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kmeans_instantiation_takes_whole_aligned_rows(dtype):
    """The 16-byte instantiation needs rows that start on 16 bytes and are
    whole 16-byte loads long; anything else takes the scalar one."""
    step = 16 // torch.empty(0, dtype=dtype).element_size()
    pick = build.vector_rows
    assert pick(torch.zeros(10, 1024, dtype=dtype))
    assert pick(torch.zeros(1, 8 * step, dtype=dtype))
    assert not pick(torch.zeros(10, 37, dtype=dtype))
    assert not pick(torch.zeros(10, 1023, dtype=dtype))
    assert not pick(torch.zeros(1, step + 1, dtype=dtype))
    flat = torch.zeros(10 * 1024 + 1, dtype=dtype)[1:].view(10, 1024)
    assert not pick(flat)  # every row off 16 bytes
    odd = torch.zeros(11, 1024 + step // 2, dtype=dtype)[1:]
    assert not pick(odd)


def test_simvote_instantiation_and_block_rows():
    pick = build.vector_rows
    assert pick(torch.zeros(5, 1024), torch.zeros(2, 3, 1024))
    assert not pick(torch.zeros(5, 1023), torch.zeros(2, 3, 1023))
    assert not pick(torch.zeros(5 * 64 + 1)[1:].view(5, 64),
                    torch.zeros(2, 3, 64))
    assert not pick(torch.zeros(5, 64),
                    torch.zeros(2 * 3 * 64 + 1)[1:].view(2, 3, 64))
    rows = simvote_kernel.block_rows
    # a round of 4 clusters of ~12,400 rows: 776 blocks of 64 on 132 SMs
    assert rows([12_400] * 4, 132) == 64
    # one cluster of ~9,500 rows: 149 blocks of 64 would leave SMs idle
    assert rows([9_500], 132) == 32
    assert rows([0, 0], 132) == 32
    assert rows([64 * 4 * 132], 132) == 64


@pytest.mark.parametrize("over,match", [(0, "CUDA tensors"),
                                         (1, "D at most 58048")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kmeans_wrapper_takes_d_up_to_shared_memory(over, match, dtype):
    """One centroid row in f32 must fit a block's shared memory: D up to
    MAX_DIM passes the wrapper's check (and, on the CPU, stops at the
    device check), a wider D is refused before anything is launched."""
    d = kmeans_kernel.MAX_DIM + over
    with pytest.raises(ValueError, match=match):
        assign_clusters_cuda(torch.zeros(2, d, dtype=dtype),
                             torch.zeros(1, d, dtype=dtype))


# ---------------------------------------------- CUDA kernels on the card
def _fix_block_rows(monkeypatch, rows):
    """Make the SimVote wrappers take ``rows`` rows a block (None: the
    height ``block_rows`` picks from the input)."""
    if rows is not None:
        monkeypatch.setattr(simvote_kernel, "block_rows",
                            lambda counts, sms: rows)


def _check_assign(x, c):
    before = assign_clusters_cuda.launches
    a1, d1 = assign_clusters_cuda(x, c)
    a2, d2 = assign_clusters_ref(x, c)
    torch.cuda.synchronize()
    assert assign_clusters_cuda.launches == before + 1
    assert (a1 == a2).float().mean().item() >= 0.999
    tol = 1e-5 if x.dtype == torch.float32 else 5e-2
    torch.testing.assert_close(d1, d2, rtol=tol, atol=tol)
    return a1


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", [
    (300, 37, 5), (257, 1023, 4),            # the scalar instantiation
    (1000, 1024, 1), (999, 256, 33), (500, 256, 64),   # K 1, 33, 64
    (1001, 128, 4), (7, 64, 4),              # n off a block's rows
    (300, 4096, 8), (64, 20_000, 3),         # passes over K for large D
    (64, kmeans_kernel.MAX_DIM, 3),          # the widest row it takes
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kmeans_assign_wide_matches_plain(cuda, n, d, k, dtype):
    x, c = _points(n, d, k, n + d + k)
    _check_assign(*(torch.from_numpy(a).to(TORCH_DTYPES[dtype]).to(cuda)
                    for a in (x, c)))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1024, 1028])
def test_cuda_kmeans_assign_unaligned_bf16_views(cuda, d):
    """x[1:] (rows 8 bytes off 16 at d 1028) and a flat view one element
    off 16 bytes take the scalar instantiation and give the same result."""
    x, c = _points(401, d, 6, d)
    xt = torch.from_numpy(x).to(torch.bfloat16).to(cuda)
    ct = torch.from_numpy(c).to(torch.bfloat16).to(cuda)
    flat = torch.empty(400 * d + 1, dtype=torch.bfloat16, device=cuda)
    flat = flat[1:].view(400, d)
    flat.copy_(xt[1:])
    for view in (xt[1:], flat):
        assert build.vector_rows(view) == (view.data_ptr() % 16 == 0
                                           and d % 8 == 0)
        _check_assign(view, ct)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,dups", [(2000, 1024, [0, 0, 1, 0]),
                                      (700, 37, [0, 1, 0, 2, 1]),
                                      (900, 96, list(range(17)) + [2, 5])])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kmeans_assign_ties_go_to_the_lowest_index(cuda, n, d, dups,
                                                        dtype):
    """Duplicate centroids tie exactly; the lowest index wins, also when
    the duplicate falls in a later pass over K (K 19 > 16)."""
    x, base = _points(n, d, max(dups) + 1, n + d)
    c = base[dups]
    a = _check_assign(*(torch.from_numpy(t).to(TORCH_DTYPES[dtype]).to(cuda)
                        for t in (x, c)))
    first = {v: dups.index(v) for v in dups}
    allowed = sorted(first.values())
    assert set(a.cpu().numpy().tolist()) <= set(allowed)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,d", [(500, 129, 64), (300, 300, 1023),
                                   (2000, 600, 256), (1, 101, 1024)])
@pytest.mark.parametrize("rows", [None, 32, 64])
def test_cuda_simvote_many_samples_matches_plain(cuda, monkeypatch, n, m, d,
                                                 rows):
    _fix_block_rows(monkeypatch, rows)
    rng = np.random.default_rng(n + m + d)
    x, s = (torch.from_numpy(rng.normal(size=(r, d)).astype(np.float32))
            .to(cuda) for r in (n, m))
    y = torch.from_numpy((rng.random(m) > 0.5).astype(np.float32)).to(cuda)
    tau = float(np.sqrt(d))
    torch.testing.assert_close(simvote_scores_cuda(x, s, y, tau),
                               simvote_scores_ref(x, s, y, tau), **SIM_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("counts,ms,d,pad_labels", [
    ([700, 65, 300], [129, 300, 600], 1024, ()),     # several sample tiles
    ([120, 1, 0, 333], [101, 300, 7, 129], 1023, ()),  # one row, empty, scalar
    ([0, 90, 40], [5, 101, 600], 64, (1,)),          # labels all padding
    ([1, 1, 1], [1, 2, 128], 37, ()),
    # a join round's blocks at the pair width 2 x 1024, M 101 each
    ([3000, 850, 40, 1200, 1], [101] * 5, 2048, ()),
])
@pytest.mark.parametrize("rows", [None, 32, 64])
def test_cuda_simvote_segmented_wide_matches_plain(cuda, monkeypatch, counts,
                                                   ms, d, pad_labels, rows):
    _fix_block_rows(monkeypatch, rows)
    x, counts, s_pad, y_pad, taus = _segmented_inputs(counts, ms, d,
                                                      pad_labels=pad_labels)
    args = (torch.from_numpy(x).to(cuda), counts,
            torch.from_numpy(s_pad).to(cuda), torch.from_numpy(y_pad).to(cuda),
            taus)
    before = simvote_scores_segmented_cuda.launches
    got = simvote_scores_segmented_cuda(*args)
    want = simvote_scores_segmented_ref(*args)
    torch.cuda.synchronize()
    assert simvote_scores_segmented_cuda.launches == before + 1
    torch.testing.assert_close(got, want, **SIM_TOL)
    if pad_labels:
        stop = np.cumsum(counts)
        for i in pad_labels:  # no evidence: every weight is 0, the score 0
            assert (got[stop[i] - counts[i]:stop[i]] == 0).all()
