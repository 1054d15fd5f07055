"""The training substrate of the port against the JAX reference, on the
CPU: ``PackedLoader`` byte for byte, the tree helpers, gradient
compression on identical gradients, ``MeshRules`` over every parameter of
the thirteen archs on the production meshes (the reference's rules built
on a ``jax.sharding.AbstractMesh``), ``param_logical_axes``,
``abstract_params`` and ``input_specs`` field for field, the mesh
descriptions, ``shard_act``'s context, and the checkpoint's parallel
zlib stream read by the reference's reader.

The port keeps each superblock's leaves apart where the reference stacks
them on a leading axis, so a reference leaf ``blocks/<path>`` of shape
(n, *s) with axes (None, *a) is the port's ``blocks/<i>/<path>`` of shape
s with axes a, for every i.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as jload_pytree
from repro.configs import get_config as jget_config
from repro.configs import input_specs as jinput_specs
from repro.configs import list_archs as jlist_archs
from repro.configs import smoke_config as jsmoke
from repro.data.loader import PackedLoader as JPackedLoader
from repro.distributed.rules import MeshRules as JMeshRules
from repro.models import lm as jlm
from repro.models.config import SHAPES as JSHAPES
from repro.train import grad_compression as jgc
from repro.utils import tree as jtree
from repro_torch.checkpoint import manager
from repro_torch.configs import get_config, input_specs
from repro_torch.configs import smoke_config
from repro_torch.data import HashTokenizer, PackedLoader, make_dataset
from repro_torch.distributed import (MeshRules, current_rules, resolve_spec,
                                     shard_act, sharding_context)
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import lm
from repro_torch.models.config import SHAPES
from repro_torch.train import grad_compression as tgc
from repro_torch.utils import tree as ttree

# the decoder archs (e5-large is the embedding encoder's config)
ARCHS = [a for a in jlist_archs() if jget_config(a).family != "encoder"]
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
_is_axes = lambda x: isinstance(x, tuple) and all(
    isinstance(e, (str, type(None))) for e in x)


def _stacked_view(tree, stacked=("blocks", "enc_blocks")):
    """A port tree as {reference path: [leaf of each superblock]}."""
    out = {}
    for path, leaf in ttree.tree_leaves_with_path(tree, is_leaf=_is_axes):
        parts = path.split("/")
        if parts[0] in stacked:
            parts = parts[:1] + parts[2:]
        out.setdefault("/".join(parts), []).append(leaf)
    return out


def _ref_paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=_is_axes)[0]
    return {jtree._path_str(p): leaf for p, leaf in flat}


# ------------------------------------------------------------ the loader


def _docs():
    tok = HashTokenizer(512)
    return [tok.encode(t) for t in make_dataset("imdb_review", n=60,
                                                seed=0).texts]


@pytest.mark.parametrize("n_hosts", [1, 2])
def test_packed_loader_batches_equal_the_reference(n_hosts):
    """Steps 0-300 byte for byte: 60 short documents give a stream that
    wraps its epoch many times at batch 3 x 17."""
    docs = _docs()
    for host in range(n_hosts):
        kw = dict(batch=3, seq=16, seed=5, host_id=host, n_hosts=n_hosts)
        ref, got = JPackedLoader(docs, **kw), PackedLoader(docs, **kw)
        assert len(ref._epoch_stream(0)) < 300 * 3 * 17  # wraps
        for step in range(301):
            a, b = ref.batch_at(step), got.batch_at(step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                    b[k].tobytes(), (host, step, k)
        it = got.iterate(start_step=7)
        for step in range(7, 12):
            b = next(it)
            assert b["tokens"].tobytes() == \
                ref.batch_at(step)["tokens"].tobytes()
        it.close()


# ------------------------------------------------------------ tree utils


def test_tree_helpers_equal_the_reference():
    rng = np.random.default_rng(0)
    np_tree = {"b": [rng.standard_normal((3, 4)).astype(np.float32),
                     rng.standard_normal((5,)).astype(np.float32)],
               "a": {"y": rng.standard_normal((2, 2)).astype(np.float32),
                     "x": np.arange(6, dtype=np.int32)}}
    tt = ttree.tree_map(torch.from_numpy, np_tree)
    jt = jax.tree_util.tree_map(jnp.asarray, np_tree)
    assert ttree.tree_param_count(tt) == jtree.tree_param_count(jt)
    assert ttree.tree_size_bytes(tt) == jtree.tree_size_bytes(jt)
    paths = []
    jpaths = []
    ttree.tree_map_with_path_str(lambda p, x: paths.append(p), tt)
    jtree.tree_map_with_path_str(lambda p, x: jpaths.append(p), jt)
    assert paths == jpaths == ["a/x", "a/y", "b/0", "b/1"]
    assert [torch.equal(a, torch.from_numpy(np.asarray(b))) for a, b in zip(
        ttree.tree_leaves(tt), jax.tree_util.tree_leaves(jt))] == [True] * 4
    floats = {"b": np_tree["b"], "y": np_tree["a"]["y"]}
    tf = ttree.tree_map(torch.from_numpy, floats)
    jf = jax.tree_util.tree_map(jnp.asarray, floats)
    np.testing.assert_allclose(float(ttree.global_norm(tf)),
                               float(jtree.global_norm(jf)), rtol=1e-6)
    for got, want in ((ttree.tree_add(tf, tf), jtree.tree_add(jf, jf)),
                      (ttree.tree_scale(tf, 0.5), jtree.tree_scale(jf, 0.5)),
                      (ttree.tree_zeros_like(tf), jtree.tree_zeros_like(jf))):
        for a, b in zip(ttree.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_tree_size_bytes_on_meta_tensors():
    for arch in ("qwen1.5-0.5b", "jamba-v0.1-52b"):
        cfg = get_config(arch)
        abstract = lm.abstract_params(cfg)
        assert all(t.is_meta for t in ttree.tree_leaves(abstract))
        assert ttree.tree_size_bytes(abstract) == \
            jtree.tree_size_bytes(jlm.abstract_params(jget_config(arch)))
        assert ttree.tree_param_count(abstract) == cfg.param_count()


# ---------------------------------------------------- grad compression


def test_compression_primitives_equal_the_reference():
    rng = np.random.default_rng(1)
    for shape in ((256,), (33, 17)):
        g = rng.standard_normal(shape).astype(np.float32)
        g.flat[:5] = g.flat[5]          # ties at every magnitude
        g.flat[7] = 0.5 * g.max() / 127  # a half quantum, to even
        np.testing.assert_array_equal(
            tgc._int8_roundtrip(torch.from_numpy(g)).numpy(),
            np.asarray(jgc._int8_roundtrip(jnp.asarray(g))))
        for frac in (0.1, 0.2, 0.5, 1e-4):
            np.testing.assert_array_equal(
                tgc._topk_mask(torch.from_numpy(g), frac).numpy(),
                np.asarray(jgc._topk_mask(jnp.asarray(g), frac)))
    # the k-th largest value ties: every entry at the threshold is kept
    g = np.array([3.0, 1.0, 2.0, 2.0, 2.0, -2.0, 0.5], np.float32)
    got = tgc._topk_mask(torch.from_numpy(g), 2 / 7).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jgc._topk_mask(jnp.asarray(g), 2 / 7)))
    assert (got != 0).sum() == 5


@pytest.mark.parametrize("method", ["int8", "topk"])
def test_compress_grads_on_stacked_superblocks(method):
    """The same gradient tree in both layouts: one int8 scale and one
    top-k over all superblocks of a leaf, as the reference's stacked
    array; error feedback likewise."""
    cfg = smoke_config("jamba-v0.1-52b")
    rng = np.random.default_rng(2)
    jtree_np = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        jlm.abstract_params(jsmoke("jamba-v0.1-52b")))
    tg = lm.params_from_jax(cfg, jtree_np, device="cpu")
    jg = jax.tree_util.tree_map(jnp.asarray, jtree_np)
    want = lm.params_from_jax(cfg, jax.tree_util.tree_map(
        np.asarray, jgc.compress_grads(jg, method)), device="cpu")
    got = tgc.compress_grads(tg, method)
    for a, b in zip(ttree.tree_leaves(want), ttree.tree_leaves(got)):
        np.testing.assert_array_equal(b.numpy(), a.numpy())
    res0 = jax.tree_util.tree_map(lambda a: 0.1 * a, jtree_np)
    jc, je = jgc.compress_with_feedback(
        jg, jax.tree_util.tree_map(jnp.asarray, res0), method)
    tc, te = tgc.compress_with_feedback(
        tg, lm.params_from_jax(cfg, res0, device="cpu"), method)
    for jt, tt in ((jc, tc), (je, te)):
        want = lm.params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jt),
                                  device="cpu")
        for a, b in zip(ttree.tree_leaves(want), ttree.tree_leaves(tt)):
            np.testing.assert_array_equal(b.numpy(), a.numpy())
    assert all(torch.count_nonzero(r) == 0 for r in
               ttree.tree_leaves(tgc.init_residuals(tg)))


# ------------------------------------------------------------ mesh rules


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_rules_for_every_param_leaf(arch, mesh):
    sizes, names = MESHES[mesh]
    jrules = JMeshRules(jax.sharding.AbstractMesh(sizes, names))
    trules = MeshRules(make_production_mesh(multi_pod=mesh == "multipod",
                                            virtual=True))
    jcfg, tcfg = jget_config(arch), get_config(arch)
    jaxes = _ref_paths(jlm.param_logical_axes(jcfg))
    jshapes = _ref_paths(jlm.abstract_params(jcfg))
    taxes = _stacked_view(lm.param_logical_axes(tcfg))
    tshapes = _stacked_view(lm.abstract_params(tcfg))
    assert jaxes.keys() == taxes.keys() == tshapes.keys()
    for path, ax in jaxes.items():
        stacked = path.split("/")[0] in ("blocks", "enc_blocks")
        want = tuple(jrules.spec(ax, jshapes[path].shape))
        for tax, leaf in zip(taxes[path], tshapes[path]):
            got = trules.spec(tax, tuple(leaf.shape))
            assert got == (want[1:] if stacked else want), (path, got, want)
    assert sorted(set(trules.warnings)) == sorted(set(jrules.warnings))
    assert resolve_spec({"data": 16, "model": 16}, ("embed", "heads"),
                        (512, 8)) == (("data"), None)


def test_shard_act_resolves_in_context_and_returns_x():
    x = torch.zeros((4, 6, 8))
    assert shard_act(x, ("batch", None, "vocab")) is x and \
        current_rules() is None
    rules = MeshRules({"data": 16, "model": 16})
    with sharding_context(rules):
        assert current_rules() is rules
        assert shard_act(x, ("batch", None, "vocab")) is x
    assert current_rules() is None
    assert rules.warnings == ["drop batch->('data',): dim 4 % 16 != 0",
                              "drop vocab->('model',): dim 8 % 16 != 0"]


def test_meshes():
    pod = make_production_mesh(virtual=True)
    assert pod.shape == {"data": 16, "model": 16} and pod.size == 256
    assert make_production_mesh(multi_pod=True, virtual=True).shape == {
        "pod": 2, "data": 16, "model": 16}
    with pytest.raises(RuntimeError, match="need 256 devices"):
        make_production_mesh(device="cpu")
    assert pod.device_mesh is None  # a layout only
    # a local mesh stands over a process group; without one it raises
    # (tests/test_torch_sharded.py builds one over a gloo group)
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_local_mesh(1, 1, device="cpu")
    with pytest.raises(RuntimeError):
        make_local_mesh(2, 1, device="cpu")


# ------------------------------------- logical axes, abstract params, specs


@pytest.mark.parametrize("arch", ARCHS)
def test_logical_axes_and_abstract_params_field_for_field(arch):
    jcfg, tcfg = jget_config(arch), get_config(arch)
    jaxes = _ref_paths(jlm.param_logical_axes(jcfg))
    jshapes = _ref_paths(jlm.abstract_params(jcfg))
    taxes = _stacked_view(lm.param_logical_axes(tcfg))
    tshapes = _stacked_view(lm.abstract_params(tcfg))
    assert jaxes.keys() == taxes.keys() == tshapes.keys()
    for path in jaxes:
        stacked = path.split("/")[0] in ("blocks", "enc_blocks")
        n = jshapes[path].shape[0] if stacked else 1
        assert len(tshapes[path]) == len(taxes[path]) == n, path
        want_shape = jshapes[path].shape[1:] if stacked else \
            jshapes[path].shape
        want_axes = jaxes[path][1:] if stacked else jaxes[path]
        for ax, leaf in zip(taxes[path], tshapes[path]):
            assert ax == tuple(want_axes), path
            assert tuple(leaf.shape) == tuple(want_shape), path
            assert str(leaf.dtype).split(".")[1] == \
                jnp.dtype(jshapes[path].dtype).name, path


@pytest.mark.parametrize("shape", sorted(JSHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_field_for_field(arch, shape):
    jcfg, tcfg = jget_config(arch), get_config(arch)
    want, got = jinput_specs(jcfg, JSHAPES[shape]), input_specs(
        tcfg, SHAPES[shape])
    assert want.keys() == got.keys()
    for k in want:
        if k == "cache":
            jc = _ref_paths(want[k])
            tc = {}
            for i, sb in enumerate(got[k]):
                for path, leaf in ttree.tree_leaves_with_path(sb):
                    tc.setdefault(path, []).append(leaf)
            assert jc.keys() == tc.keys()
            for path, leaf in jc.items():
                assert len(tc[path]) == leaf.shape[0]
                for t in tc[path]:
                    assert t.is_meta and tuple(t.shape) == leaf.shape[1:]
                    assert str(t.dtype).split(".")[1] == \
                        jnp.dtype(leaf.dtype).name
            axes = lm.cache_logical_axes(tcfg)
            jaxes = _ref_paths(jlm.cache_logical_axes(jcfg))
            for sb in axes:
                for path, ax in ttree.tree_leaves_with_path(
                        sb, is_leaf=_is_axes):
                    assert ax == jaxes[path][1:], path
        else:
            assert got[k].is_meta and tuple(got[k].shape) == want[k].shape
            assert str(got[k].dtype).split(".")[1] == \
                jnp.dtype(want[k].dtype).name


# ------------------------------------------------------------ checkpoint


def test_parallel_zlib_checkpoint_reads_in_both_packages(tmp_path,
                                                         monkeypatch):
    """A checkpoint written with its blob in many parallel pieces is one
    zlib stream: the reference's reader and the port's restore it."""
    monkeypatch.setattr(manager, "ZLIB_PIECE", 1 << 12)
    rng = np.random.default_rng(4)
    tree = {"w": torch.from_numpy(rng.standard_normal((300, 70))
                                  .astype(np.float32)).to(torch.bfloat16),
            "m": [torch.from_numpy(rng.standard_normal(5000)
                                   .astype(np.float32)),
                  torch.zeros(4096)],
            "step": torch.tensor(7, dtype=torch.int32)}
    manager.save_pytree(tree, tmp_path / "ck", codec="zlib")
    blob, = (tmp_path / "ck").glob("shard_000.msgpack.zlib")
    assert blob.stat().st_size > 4 * manager.ZLIB_PIECE // 2
    flat, _ = jload_pytree(tmp_path / "ck")
    want = dict(ttree.tree_leaves_with_path(tree))
    assert flat.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k], v.float().numpy()
                                      if v.dtype == torch.bfloat16
                                      else v.numpy())
    back, _ = manager.load_pytree(tmp_path / "ck", tree)
    for a, b in zip(ttree.tree_leaves(back), ttree.tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
