"""The partitioned program of the port against the JAX reference, on the
CPU.

- ``MeshRules.placements``: every leaf of the parameters, the optimizer
  state, the decode cache and the inputs of every decoder smoke config,
  placed as a DTensor on the pod and multipod meshes (a ``fake`` group of
  256 and 512 ranks in a process of its own), has the local shape of the
  reference's ``NamedSharding.shard_shape`` (its rules on an
  ``AbstractMesh``).
- ``launch.collectives`` on single-operation programs whose strategy is
  forced, against the reference's ``parse_collective_bytes`` of the
  compiled, partitioned HLO of the same program (8 forced host devices in
  a process of its own; the port on a ``fake`` group of 8 ranks): a
  row-sharded product gathered whole (all-gather), a product over a split
  contraction made whole (all-reduce) or split by rows (reduce-scatter;
  the reference's CPU compiler turns that one into an all-reduce and a
  slice under ``jit``, so its side is ``psum_scatter`` under
  ``shard_map``), and the MoE buffer moved from its capacity dim to its
  experts (all-to-all).  Kinds, counts and bytes are exactly equal.
- A partitioned train step on a real 4-rank gloo group, mesh (data 2,
  model 2), in processes of their own, for a dense and a MoE + Mamba
  smoke arch and with top-k compression: the loss, the grad norm and
  every leaf equal the unpartitioned port step within
  ``tests/test_torch_train.py``'s tolerances.
- The elastic restore on the same group: a checkpoint saved unsharded
  restored onto the (2, 2) placements (each rank's blocks exact) and
  saved again from there (the shard file byte for byte the same), and the
  reference's own checkpoint restored onto the port's placements (each
  block equal to its unsharded restore).
- ``shard_act`` passes a plain tensor through, in any context; K4 and K5
  refuse DTensors; a mesh needs a process group of its size.

The smoke dry-run cells (argument bytes, collectives, the three roofline
terms, per-device FLOPs) are ``tests/test_torch_dryrun.py``'s.
"""
import datetime
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.checkpoint import save_pytree as jsave_pytree
from repro.configs import get_config as jget_config
from repro.configs import input_specs as jinput_specs
from repro.configs import list_archs as jlist_archs
from repro.configs import smoke_config as jsmoke
from repro.distributed.rules import MeshRules as JMeshRules
from repro.models import lm as jlm
from repro.models.config import ShapeCell as JShapeCell
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.optimizer import adamw_init as jadamw_init
from repro.train.optimizer import opt_logical_axes as jopt_logical_axes
from repro.utils import tree as jtree
from repro_torch.checkpoint import load_pytree
from repro_torch.configs import smoke_config
from repro_torch.distributed import MeshRules, shard_act, sharding_context
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import lm
from repro_torch.train import OptConfig, adamw_init, make_train_step
from repro_torch.utils.tree import tree_leaves_with_path
from test_torch_train import (METRIC_RTOL, MOMENT_ATOL, _assert_adam_close,
                              _assert_tree_close)

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
ARCHS = [a for a in jlist_archs() if jget_config(a).family != "encoder"]
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
LR = 3e-3
TRAIN_CASES = [("qwen1.5-0.5b", None), ("jamba-v0.1-52b", None),
               ("qwen1.5-0.5b", "topk")]
# (arch, long_context): the cache's slots split over the model axis
# (kv_seq), or over data and model (kv_seq_long, on one sequence, which
# leaves the data axis to the slots); either way a decode step reads a
# slot-split cache
SERVE_CASES = [("qwen1.5-0.5b", False), ("qwen1.5-0.5b", True),
               ("jamba-v0.1-52b", False)]
B, S = 4, 16  # the gloo step's batch: 2 sequences a data rank
MAX_LEN, STEPS = 24, 3  # the serving cache's slots; decode steps
_is_axes = lambda x: isinstance(x, tuple) and all(
    isinstance(e, (str, type(None))) for e in x)


def _python(code, *args, env=None, timeout=300):
    """Run ``code`` in a fresh interpreter; its last stdout line is
    JSON."""
    proc = subprocess.run([sys.executable, "-c", code, *map(str, args)],
                          env=env or ENV, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


# --------------------------------------------------------- placements

_PLACEMENTS = textwrap.dedent("""
    import json, sys, torch.distributed as dist
    from repro_torch.configs import (input_logical_axes, input_specs,
                                     smoke_config)
    from repro_torch.distributed.api import place
    from repro_torch.distributed.rules import MeshRules
    from repro_torch.launch.mesh import (make_production_mesh,
                                         virtual_device_mesh)
    from repro_torch.models import lm
    from repro_torch.models.config import ShapeCell
    from repro_torch.train.optimizer import (OptConfig, adamw_init,
                                             opt_logical_axes)
    from repro_torch.utils.tree import tree_leaves_with_path

    def smoke_trees(cfg):
        # meta trees; batch 32 divides both meshes' batch axes
        params = lm.abstract_params(cfg)
        return {"params": params, "opt": adamw_init(params, OptConfig()),
                "cache": input_specs(cfg, ShapeCell("d", 64, 32,
                                                    "decode"))["cache"],
                "inputs": input_specs(cfg, ShapeCell("t", 32, 32, "train"))}

    archs = sys.argv[1:]
    out = {}
    for kind in ("pod", "multipod"):
        mesh = virtual_device_mesh(make_production_mesh(
            multi_pod=kind == "multipod", virtual=True))
        rules = MeshRules(mesh)
        for arch in archs:
            cfg = smoke_config(arch)
            trees = smoke_trees(cfg)
            p_axes = lm.param_logical_axes(cfg)
            axes = {"params": p_axes,
                    "opt": opt_logical_axes(p_axes, OptConfig()),
                    "cache": lm.cache_logical_axes(cfg),
                    "inputs": input_logical_axes(trees["inputs"])}
            is_axes = lambda x: isinstance(x, tuple) and all(
                isinstance(e, (str, type(None))) for e in x)
            got = {}
            for name, tree in trees.items():
                ax = dict(tree_leaves_with_path(axes[name], is_leaf=is_axes))
                for path, leaf in tree_leaves_with_path(tree):
                    spec = rules.spec(ax[path], tuple(leaf.shape))
                    local = place(leaf, mesh.device_mesh,
                                  rules.placements(spec)).to_local()
                    got[f"{name}/{path}"] = [
                        list(local.shape),
                        list(rules.shard_shape(spec, tuple(leaf.shape)))]
            out[f"{arch}|{kind}"] = got
        dist.destroy_process_group()
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def port_placements():
    return _python(_PLACEMENTS, *ARCHS, timeout=600)


def _stacked(name, key) -> bool:
    """Whether a reference leaf is stacked over the superblocks: every
    cache leaf, and the parameters' (and their moments') under
    ``blocks`` or ``enc_blocks``."""
    parts = key.split("/")
    if name == "opt":
        parts = parts[1:]
    return name == "cache" or (name in ("params", "opt") and bool(parts)
                               and parts[0] in ("blocks", "enc_blocks"))


def _ref_shard_shapes(arch, mesh):
    """{(tree, reference path): the reference's shard shape, without the
    stacked dim of a stacked leaf} of the four trees of a smoke config."""
    jcfg = jsmoke(arch)
    jrules = JMeshRules(AbstractMesh(*MESHES[mesh]))
    params = jlm.abstract_params(jcfg)
    oc = JOptConfig()
    p_axes = jlm.param_logical_axes(jcfg)
    specs = jinput_specs(jcfg, JShapeCell("t", 32, 32, "train"))
    b_axes = {k: ("batch",) + (None,) * (v.ndim - 1)
              for k, v in specs.items()}
    trees = {"params": (p_axes, params),
             "opt": (jopt_logical_axes(p_axes, oc),
                     jax.eval_shape(lambda p: jadamw_init(p, oc), params)),
             "cache": (jlm.cache_logical_axes(jcfg), jinput_specs(
                 jcfg, JShapeCell("d", 64, 32, "decode"))["cache"]),
             "inputs": (b_axes, specs)}
    out = {}
    for name, (axes, tree) in trees.items():
        leaves = {jtree._path_str(p): leaf for p, leaf in
                  jax.tree_util.tree_flatten_with_path(tree)[0]}
        for path, ax in jax.tree_util.tree_flatten_with_path(
                axes, is_leaf=_is_axes)[0]:
            key = jtree._path_str(path)
            leaf = leaves[key]
            shard = NamedSharding(jrules.mesh, jrules.spec(
                ax, leaf.shape)).shard_shape(leaf.shape)
            out[(name, key)] = list(shard[1:] if _stacked(name, key)
                                    else shard)
    return out


def _port_key(name, path):
    """A port path as the reference's: the superblock index dropped."""
    parts = path.split("/")
    if name == "cache":
        return "/".join(parts[1:])
    at = 1 if name == "opt" else 0
    if name in ("params", "opt") and len(parts) > at + 1 and \
            parts[at] in ("blocks", "enc_blocks"):
        parts = parts[:at + 1] + parts[at + 2:]
    return "/".join(parts)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_placements_give_the_reference_shard_shapes(arch, mesh,
                                                    port_placements):
    got = port_placements[f"{arch}|{mesh}"]
    want = _ref_shard_shapes(arch, mesh)
    seen = set()
    for key, (local, shard) in got.items():
        name, path = key.split("/", 1)
        ref = want[(name, _port_key(name, path))]
        assert local == shard == ref, (arch, mesh, key, local, shard, ref)
        seen.add((name, _port_key(name, path)))
    assert seen == set(want), sorted(set(want) - seen)[:5]


# ------------------------------------------------------- collectives

_PORT_PROGRAMS = textwrap.dedent("""
    import json, torch, torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.distributed.api import place
    from repro_torch.launch.collectives import CollectiveCounter
    from repro_torch.launch.mesh import Mesh, virtual_device_mesh
    mesh = virtual_device_mesh(Mesh(("x",), (8,))).device_mesh
    meta = lambda *s: torch.empty(s, device="meta")
    R, S0, S1 = [Replicate()], [Shard(0)], [Shard(1)]
    programs = {
        "all_gather": ((meta(64, 32), S0), (meta(32, 32), R), R),
        "all_reduce": ((meta(64, 32), S1), (meta(32, 48), S0), R),
        "reduce_scatter": ((meta(64, 32), S1), (meta(32, 48), S0), S0),
    }
    out = {}
    for name, ((x, px), (w, pw), po) in programs.items():
        x, w = place(x, mesh, px), place(w, mesh, pw)
        with CollectiveCounter() as c:
            (x @ w).redistribute(mesh, po)
        out[name] = c.report()
    buf = place(meta(8, 16, 32), mesh, S1)  # (E, C, D), capacity split
    with CollectiveCounter() as c:
        (buf * 2).redistribute(mesh, S0)     # experts split
    out["all_to_all"] = c.report()
    dist.destroy_process_group()
    print(json.dumps(out))
""")

_REF_PROGRAMS = textwrap.dedent("""
    import json
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    devices = jax.devices()[:8]  # the backend starts with the 8 forced
    from repro.launch.dryrun import parse_collective_bytes
    mesh = Mesh(np.array(devices), ("x",))
    S = lambda *p: NamedSharding(mesh, P(*p))
    f32 = lambda *s: jax.ShapeDtypeStruct(s, jnp.float32)
    mm = lambda x, w: x @ w

    def hlo(fn, args, ins=None, out=None):
        jit = jax.jit(fn) if ins is None else jax.jit(
            fn, in_shardings=ins, out_shardings=out)
        return parse_collective_bytes(jit.lower(*args).compile().as_text())

    scatter = jax.shard_map(
        lambda x, w: jax.lax.psum_scatter(x @ w, "x", scatter_dimension=0,
                                          tiled=True),
        mesh=mesh, in_specs=(P(None, "x"), P("x", None)),
        out_specs=P("x", None))
    out = {
        "all_gather": hlo(mm, (f32(64, 32), f32(32, 32)),
                          (S("x", None), S()), S()),
        "all_reduce": hlo(mm, (f32(64, 32), f32(32, 48)),
                          (S(None, "x"), S("x", None)), S()),
        "reduce_scatter": hlo(scatter, (f32(64, 32), f32(32, 48))),
        "all_to_all": hlo(lambda b: b * 2, (f32(8, 16, 32),),
                          (S(None, "x", None),), S("x", None, None)),
    }
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def collective_reports():
    ref_env = dict(ENV, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8")
    return _python(_PORT_PROGRAMS), _python(_REF_PROGRAMS, env=ref_env)


@pytest.mark.parametrize("program", ["all_gather", "all_reduce",
                                     "reduce_scatter", "all_to_all"])
def test_collective_counter_equals_the_reference_hlo(program,
                                                     collective_reports):
    port, ref = collective_reports
    kind = program.replace("_", "-")
    assert ref[program]["counts"][kind] == 1, ref[program]
    assert port[program] == ref[program]


# --------------------------------------------- gloo: a partitioned step

_RANK = textwrap.dedent("""
    import datetime, json, sys
    import numpy as np, torch, torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager, load_pytree
    from repro_torch.configs import input_logical_axes, smoke_config
    from repro_torch.distributed.api import (distribute_tree, gather_tree,
                                             partitioned, place, shard_act,
                                             sharding_context,
                                             tree_placements)
    from repro_torch.distributed.rules import MeshRules
    from repro_torch.kernels.decode_attention.kernel import \\
        decode_attention_cuda
    from repro_torch.kernels.flash_attention.kernel import \\
        flash_attention_cuda
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm
    from repro_torch.train import OptConfig, adamw_init, make_train_step
    from repro_torch.train.optimizer import opt_logical_axes
    from repro_torch.utils.tree import tree_leaves_with_path, tree_map
    work, rank = sys.argv[1], int(sys.argv[2])
    cases, serve_cases = json.loads(sys.argv[3]), json.loads(sys.argv[4])
    dist.init_process_group(
        "gloo", store=dist.FileStore(work + "/store", 4), rank=rank,
        world_size=4, timeout=datetime.timedelta(seconds=120))
    report = {}
    try:
        mesh = make_local_mesh(2, 2, device="cpu")
        rules = MeshRules(mesh)
        oc = OptConfig(lr=%(lr)r, warmup_steps=2, total_steps=50)
        with sharding_context(rules):
            for i, (arch, comp) in enumerate(cases):
                cfg = smoke_config(arch)
                params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                                        device="cpu")
                batch = {k: torch.from_numpy(v) for k, v in
                         np.load(f"{work}/batch{i}.npz").items()}
                axes = {"params": lm.param_logical_axes(cfg)}
                axes["opt"] = opt_logical_axes(axes["params"], oc)
                state = distribute_tree(
                    {"params": params, "opt": adamw_init(params, oc)},
                    axes, rules)
                step = make_train_step(cfg, oc, compression=comp)
                p, o, m = step(state["params"], state["opt"],
                               distribute_tree(batch,
                                               input_logical_axes(batch),
                                               rules))
                out = gather_tree({"params": p, "opt": o, "metrics": m})
                if rank == 0:
                    np.savez(f"{work}/out{i}.npz", **{
                        k: v.float().numpy() for k, v in
                        tree_leaves_with_path(out)})

            # serving: a prefill and decode steps, the cache placed
            for i, (arch, long_ctx) in enumerate(serve_cases):
                cfg = smoke_config(arch)
                params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                                        device="cpu")
                dp = distribute_tree(params, lm.param_logical_axes(cfg),
                                     rules)
                data = {k: torch.from_numpy(v).long() for k, v in
                        np.load(f"{work}/serve{i}.npz").items()}
                c_axes = lm.cache_logical_axes(cfg, long_context=long_ctx)
                out = {}
                with partitioned(dp), torch.no_grad():
                    logits, cache, _ = lm.prefill(
                        cfg, dp, distribute_tree(data["tokens"],
                                                 ("batch", None), rules),
                        max_len=%(max_len)r)
                    cache = distribute_tree(cache, c_axes, rules)
                    out["prefill"] = logits  # a decode writes the cache
                    out["prefill_cache"] = tree_map(torch.clone,
                                                    gather_tree(cache))
                    pos = distribute_tree(data["pos"], ("kv_batch",), rules)
                    for s, cur in enumerate(data["steps"]):
                        logits, cache = lm.decode_step(
                            cfg, dp, cache,
                            distribute_tree(cur, ("kv_batch",), rules), pos)
                        out[f"step{s}"] = logits
                        pos = pos + 1
                    out["cache"] = cache
                out = gather_tree(out)
                if rank == 0:
                    np.savez(f"{work}/serve_out{i}.npz", **{
                        k: v.float().numpy() for k, v in
                        tree_leaves_with_path(out)})

            # the elastic restore: the unsharded checkpoint onto (2, 2)
            cfg = smoke_config("qwen1.5-0.5b")
            params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
            tmpl = {"params": params, "opt": adamw_init(params, oc)}
            axes = {"params": lm.param_logical_axes(cfg)}
            axes["opt"] = opt_logical_axes(axes["params"], oc)
            shardings = tree_placements(tmpl, axes, rules)
            whole, _ = load_pytree(work + "/ck1/step_00000001", tmpl)
            step, got, _ = CheckpointManager(work + "/ck1").restore(
                tmpl, shardings)
            is_sharding = lambda x: isinstance(x, tuple)  # (mesh, placements)
            exact = all(
                torch.equal(g.to_local(), place(w, *sh).to_local())
                and g.placements == sh[1]
                for (_, g), (_, w), (_, sh) in zip(
                    tree_leaves_with_path(got), tree_leaves_with_path(whole),
                    tree_leaves_with_path(shardings, is_leaf=is_sharding)))
            report["restored_exact"] = exact
            CheckpointManager(work + "/ck2").save(step, got)

            # the reference's checkpoint onto the port's placements
            rtmpl = {"embed": {"table": torch.zeros(64, 32)},
                     "wq": torch.zeros(32, 48)}
            raxes = {"embed": {"table": ("vocab", "embed")},
                     "wq": ("embed", "heads")}
            rwhole, _ = load_pytree(work + "/ckref", rtmpl)
            rshard = tree_placements(rtmpl, raxes, rules)
            rgot, _ = load_pytree(work + "/ckref", rtmpl, rshard)
            report["reference_exact"] = all(
                torch.equal(g.to_local(), place(w, *sh).to_local())
                for (_, g), (_, w), (_, sh) in zip(
                    tree_leaves_with_path(rgot),
                    tree_leaves_with_path(rwhole),
                    tree_leaves_with_path(rshard, is_leaf=is_sharding)))
            report["reference_placements"] = [
                str(g.placements) for _, g in tree_leaves_with_path(rgot)]

            # plain tensors pass through a constraint; kernels refuse
            x = torch.ones(4, 6)
            report["shard_act_plain"] = shard_act(x, ("batch", None)) is x
            d = place(torch.ones(2, 2, 4, 16), mesh.device_mesh,
                      rules.placements((None,) * 4))
            refused = []
            for name, call in (
                    ("flash", lambda: flash_attention_cuda(d, d, d)),
                    ("decode", lambda: decode_attention_cuda(
                        d[:, 0], d, d, torch.ones(2, dtype=torch.int32)))):
                try:
                    call()
                except TypeError as e:
                    refused.append("DTensor" in str(e))
            report["kernels_refuse"] = refused
    finally:
        dist.destroy_process_group()
    if rank == 0:
        print(json.dumps(report))
""") % {"lr": LR, "max_len": MAX_LEN}


def _batch(arch, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, smoke_config(arch).vocab_size,
                        (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _serve_inputs(arch, seed, long_context):
    """A prompt of S tokens a row, then STEPS tokens a row written from
    positions on either side of the ranks' slot blocks (12 slots a block
    over model, 6 over data and model)."""
    rng = np.random.default_rng(100 + seed)
    vocab = smoke_config(arch).vocab_size
    pos = [11] if long_context else [16, 9, 11, 14]
    return {"tokens": rng.integers(0, vocab, (len(pos), S)).astype(np.int32),
            "steps": rng.integers(0, vocab,
                                  (STEPS, len(pos))).astype(np.int32),
            "pos": np.array(pos, np.int32)}


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    """Four gloo ranks in processes of their own run every case; rank 0
    writes the gathered results and a report."""
    from repro_torch.checkpoint import CheckpointManager
    work = tmp_path_factory.mktemp("gloo")
    for i, (arch, _) in enumerate(TRAIN_CASES):
        np.savez(work / f"batch{i}.npz", **_batch(arch, i))
    for i, (arch, long_context) in enumerate(SERVE_CASES):
        np.savez(work / f"serve{i}.npz", **_serve_inputs(arch, i,
                                                          long_context))
    cfg = smoke_config("qwen1.5-0.5b")
    oc = OptConfig(lr=LR, warmup_steps=2, total_steps=50)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    p, o, _ = make_train_step(cfg, oc)(params, adamw_init(params, oc),
                                       {k: torch.from_numpy(v) for k, v in
                                        _batch("qwen1.5-0.5b", 9).items()})
    CheckpointManager(work / "ck1").save(1, {"params": p, "opt": o})
    rng = np.random.default_rng(5)
    jsave_pytree({"embed": {"table": rng.standard_normal(
        (64, 32)).astype(np.float32)}, "wq": rng.standard_normal(
        (32, 48)).astype(np.float32)}, work / "ckref")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(work), str(r),
         json.dumps(TRAIN_CASES), json.dumps(SERVE_CASES)], env=ENV,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(4)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    return work, json.loads(outs[0][0].strip().splitlines()[-1])


@pytest.mark.parametrize("case", range(len(TRAIN_CASES)),
                         ids=[f"{a}-{c}" for a, c in TRAIN_CASES])
def test_partitioned_step_equals_the_unpartitioned_one(case, gloo_run):
    work, _ = gloo_run
    arch, comp = TRAIN_CASES[case]
    cfg = smoke_config(arch)
    oc = OptConfig(lr=LR, warmup_steps=2, total_steps=50)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             np.load(work / f"batch{case}.npz").items()}
    p, o, m = make_train_step(cfg, oc, compression=comp)(
        params, adamw_init(params, oc), batch)
    got = dict(np.load(work / f"out{case}.npz"))
    for k, v in m.items():
        np.testing.assert_allclose(got[f"metrics/{k}"], float(v),
                                   rtol=METRIC_RTOL, atol=1e-7, err_msg=k)
    as_tree = lambda prefix, tree: {  # noqa: E731
        k: torch.from_numpy(got[f"{prefix}/{k}"]).to(v.dtype)
        for k, v in tree_leaves_with_path(tree)}
    ref = lambda tree: dict(tree_leaves_with_path(tree))  # noqa: E731
    assert int(got["opt/step"]) == int(o["step"]) == 1
    _assert_adam_close(ref(p), as_tree("params", p), 2 * LR, f"{case} params")
    _assert_adam_close(ref(o["master"]), as_tree("opt/master", o["master"]),
                       2 * LR, f"{case} master")
    for k in ("mu", "nu"):
        _assert_tree_close(ref(o[k]), as_tree(f"opt/{k}", o[k]), MOMENT_ATOL,
                           f"{case} {k}")


def _cache_leaves(cache, prefix):
    """Copies of the leaves: a decode step writes the cache in place."""
    return {f"{prefix}/{k}": v.float().numpy().copy()
            for k, v in tree_leaves_with_path(cache)}


@pytest.mark.parametrize("case", range(len(SERVE_CASES)),
                         ids=[f"{a}-{'long' if c else 'seq'}"
                              for a, c in SERVE_CASES])
def test_partitioned_serving_equals_the_unpartitioned_one(case, gloo_run):
    """A prefill and decode steps on (2, 2), the cache split along its
    slots: logits and cache as the unpartitioned port's within
    ``tests/test_torch_decode.py``'s tolerances (1e-4 for logits and a
    decoded cache, 1e-5 for a prefill's cache)."""
    work, _ = gloo_run
    arch, _ = SERVE_CASES[case]
    cfg = smoke_config(arch)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    data = {k: torch.from_numpy(v).long() for k, v in
            np.load(work / f"serve{case}.npz").items()}
    got = dict(np.load(work / f"serve_out{case}.npz"))
    with torch.no_grad():
        logits, cache, _ = lm.prefill(cfg, params, data["tokens"],
                                      max_len=MAX_LEN)
        want = {"prefill": logits.numpy(),
                **_cache_leaves(cache, "prefill_cache")}
        pos = data["pos"]
        for s, cur in enumerate(data["steps"]):
            logits, cache = lm.decode_step(cfg, params, cache, cur, pos)
            want[f"step{s}"] = logits.numpy()
            pos = pos + 1
        want.update(_cache_leaves(cache, "cache"))
    assert got.keys() == want.keys()
    for k, v in want.items():
        tol = 1e-5 if k.startswith("prefill_cache") else 1e-4
        np.testing.assert_allclose(got[k], v, rtol=tol, atol=tol, err_msg=k)


def test_elastic_restore_onto_two_by_two_and_back_is_exact(gloo_run):
    work, report = gloo_run
    assert report["restored_exact"] is True
    # saved again from the (2, 2) placements: the same bytes as the
    # unsharded save, and the same tree
    (a,), (b,) = ((work / d / "step_00000001").glob("shard_*")
                  for d in ("ck1", "ck2"))
    assert a.read_bytes() == b.read_bytes()
    one, _ = load_pytree(work / "ck1" / "step_00000001")
    two, _ = load_pytree(work / "ck2" / "step_00000001")
    assert one.keys() == two.keys()
    for k in one:
        np.testing.assert_array_equal(two[k], one[k], err_msg=k)


def test_reference_checkpoint_restores_onto_the_port_placements(gloo_run):
    _, report = gloo_run
    assert report["reference_exact"] is True
    # the table split over (embed -> data, vocab -> model), wq over data
    assert report["reference_placements"] == [
        "(Shard(dim=1), Shard(dim=0))", "(Shard(dim=0), Shard(dim=1))"]


def test_kernels_refuse_dtensors(gloo_run):
    _, report = gloo_run
    assert report["kernels_refuse"] == [True, True]


def test_shard_act_passes_plain_tensors_through(gloo_run):
    _, report = gloo_run
    assert report["shard_act_plain"] is True  # a context over a DeviceMesh
    x = torch.zeros((4, 6, 8))
    assert shard_act(x, ("batch", None, "vocab")) is x  # no context
    for mesh in ({"data": 2, "model": 2},
                 make_production_mesh(virtual=True)):  # layout only
        with sharding_context(MeshRules(mesh)):
            assert shard_act(x, ("batch", None, "vocab")) is x


def test_a_mesh_needs_a_process_group_of_its_size(tmp_path):
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_local_mesh(1, 1, device="cpu")
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_local_mesh(1, 1, device="cpu")
        assert mesh.device_mesh.mesh_dim_names == ("data", "model")
        assert math.prod(mesh.device_mesh.shape) == mesh.size == 1
        with pytest.raises(RuntimeError, match="needs 2 ranks"):
            make_local_mesh(2, 1, device="cpu")
    finally:
        dist.destroy_process_group()
