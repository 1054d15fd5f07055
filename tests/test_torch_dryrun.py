"""The port's operation counter and partitioned dry run, on the CPU.

``launch.op_cost`` on the four programs of ``tests/test_hlo_cost.py``: a
512^3 matmul's FLOPs exactly, a loop of 10 and a nested 4 x 5 loop
counted trip by trip, and bytes that grow with the trip count.  A smoke
dry-run cell of each step kind (train, prefill, decode) on the pod and
multipod meshes, built as a partitioned program on a ``fake`` group of
256 (512) ranks: the bytes one device holds of the parameters, the
optimizer state, the cache and the inputs, and the program's argument
bytes, equal the reference's shard shapes (its ``MeshRules`` on a
``jax.sharding.AbstractMesh``, its trees from ``eval_shape``); the
collectives give a collective time, the dominant term is one of three,
and one device runs at least its share of the step's FLOPs.  The
unpartitioned FLOPs equal the matmuls of the same cell counted by hand
for a dense forward.  ``dryrun.main`` writes its artifacts under the
directory it is given.
"""
import json
import math

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding
from torch.distributed.tensor import Replicate, Shard

from repro.configs import input_specs as jinput_specs
from repro.configs import smoke_config as jsmoke
from repro.distributed.rules import MeshRules as JMeshRules
from repro.models import lm as jlm
from repro.models.config import ShapeCell as JShapeCell
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.optimizer import adamw_init as jadamw_init
from repro.train.optimizer import opt_logical_axes as jopt_logical_axes
from repro_torch.configs import smoke_config
from repro_torch.distributed.api import place
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, virtual_device_mesh
from repro_torch.launch.op_cost import OpCost, analyze
from repro_torch.models import lm
from repro_torch.models.config import ShapeCell
from repro_torch.utils.tree import tree_leaves

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
_is_axes = lambda x: isinstance(x, tuple) and all(
    isinstance(e, (str, type(None))) for e in x)


def _meta(*shape):
    return torch.empty(shape, device="meta")


# ---------------------------------------- tests/test_hlo_cost.py's cases


def test_plain_matmul_flops_exact():
    c = analyze(lambda a, b: a @ b, _meta(512, 512), _meta(512, 512))
    assert c.flops == 2 * 512 ** 3
    assert c.bytes == 3 * 512 * 512 * 4


def _loop(x, ws):
    for w in ws:
        x = x @ w
    return x


def test_loop_trip_count_expanded():
    c = analyze(_loop, _meta(512, 512), _meta(10, 512, 512))
    assert c.flops == 10 * 2 * 512 ** 3


def test_nested_loop_product_of_trips():
    def g(x, ws):
        for wrow in ws:
            x = _loop(x, wrow)
        return x

    c = analyze(g, _meta(256, 256), _meta(4, 5, 256, 256))
    assert c.flops == 20 * 2 * 256 ** 3


def test_bytes_scale_with_trips():
    b1 = analyze(_loop, _meta(256, 256), _meta(2, 256, 256)).bytes
    b2 = analyze(_loop, _meta(256, 256), _meta(20, 256, 256)).bytes
    assert b2 > 5 * b1


def test_views_move_no_bytes_and_real_tensors_count_too():
    with OpCost() as c:
        x = torch.ones(8, 4)
        x.t()
        x.view(32)[1:]
    assert c.flops == 0 and c.bytes == 8 * 4 * 4  # ones writes; views 0


def test_temp_bytes_of_a_placed_program_counted_by_hand():
    """On 8 ranks: a row block of x (8 of its 64 rows) times a replicated
    w holds one (8, 48) float32 block; the arguments, written in place
    or not, are no temporaries."""
    mesh = virtual_device_mesh(Mesh(("x",), (8,))).device_mesh
    try:
        x = place(_meta(64, 32), mesh, [Shard(0)])
        w = place(_meta(32, 48), mesh, [Replicate()])
        with OpCost(given=(x, w)) as c:
            x.to_local().mul_(2)
            y = x @ w
        assert y.to_local().shape == (8, 48)
        assert c.peak_bytes == 8 * 48 * 4
        assert c.flops == 2 * 8 * 32 * 48
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------ smoke dry runs


def _ref_bytes(jrules, axes, tree):
    total = 0

    def one(ax, leaf):
        nonlocal total
        spec = jrules.spec(ax, leaf.shape)
        shard = NamedSharding(jrules.mesh, spec).shard_shape(leaf.shape)
        total += math.prod(shard) * jnp.dtype(leaf.dtype).itemsize

    jax.tree_util.tree_map(one, axes, tree, is_leaf=_is_axes)
    return total


def _ref_batch_axes(specs):
    def one(name, leaf):
        if name in ("tokens", "targets"):
            return ("batch",) + (None,) * (leaf.ndim - 1)
        if name in ("prefix_embeds", "enc_frames"):
            return ("batch", None, None)
        if name == "pos":
            return ("kv_batch",)
        return (None,) * leaf.ndim
    return {k: one(k, v) for k, v in specs.items() if k != "cache"}


def _ref_cell(arch, shape, mesh):
    """The reference's per-device bytes of one cell: its trees, its
    rules on an abstract mesh, NamedSharding's shard shapes."""
    cfg = jsmoke(arch)
    jrules = JMeshRules(AbstractMesh(*MESHES[mesh]))
    p_axes = jlm.param_logical_axes(cfg)
    params = jlm.abstract_params(cfg)
    specs = jinput_specs(cfg, shape)
    out = {"params": _ref_bytes(jrules, p_axes, params),
           "inputs": _ref_bytes(jrules, _ref_batch_axes(specs),
                                {k: v for k, v in specs.items()
                                 if k != "cache"})}
    if shape.kind == "train":
        oc = JOptConfig()
        opt = jax.eval_shape(lambda p: jadamw_init(p, oc), params)
        out["opt"] = _ref_bytes(jrules, jopt_logical_axes(p_axes, oc), opt)
    elif shape.kind == "prefill":
        cache = jax.eval_shape(lambda p, s: jlm.prefill(
            cfg, p, s["tokens"], enc_frames=s.get("enc_frames"),
            max_len=shape.seq_len)[1], params, specs)
        out["cache"] = _ref_bytes(jrules, jlm.cache_logical_axes(cfg), cache)
    else:
        out["cache"] = _ref_bytes(jrules, jlm.cache_logical_axes(cfg),
                                  specs["cache"])
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "jamba-v0.1-52b",
                                  "whisper-base"])
def test_smoke_cell_bytes_per_device_equal_the_reference(arch, kind, mesh):
    shape = ShapeCell(f"smoke_{kind}", 32, 32, kind)
    art = dryrun.build_cell(arch, f"smoke_{kind}", mesh,
                            cfg=smoke_config(arch), shape=shape)
    assert art["ok"] and art["chips"] == math.prod(MESHES[mesh][0])
    want = _ref_cell(arch, JShapeCell(f"smoke_{kind}", 32, 32, kind), mesh)
    assert art["per_device_bytes"] == want
    # the program's arguments: the parameters, the optimizer state or
    # the cache it takes, and the inputs (a prefill makes its cache)
    taken = {"train": ("params", "opt", "inputs"),
             "prefill": ("params", "inputs"),
             "decode": ("params", "cache", "inputs")}[kind]
    assert art["memory"]["argument_size_in_bytes"] == sum(
        want[k] for k in taken)
    assert art["memory"]["output_size_in_bytes"] > 0
    assert art["memory"]["temp_size_in_bytes"] > 0
    if kind == "train":
        # one device's temporaries: never the whole optimizer state (a
        # float32 master and two moments of every parameter)
        n = sum(t.numel() for t in
                tree_leaves(lm.abstract_params(smoke_config(arch))))
        assert art["memory"]["temp_size_in_bytes"] < 3 * 4 * n
    assert art["torch"] == torch.__version__
    assert art["cost"]["flops"] > 0 and art["cost"]["bytes"] > 0
    assert art["cost"]["flops_per_device"] >= art["cost"]["flops"] / \
        art["chips"]
    coll = art["collectives"]
    assert coll["total_bytes"] == sum(coll["bytes"].values()) > 0
    terms = art["roofline_terms"]
    assert terms["collective_s"] == coll["total_bytes"] / dryrun.NET_BW > 0
    assert art["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert terms[art["dominant"]] == max(
        terms[k] for k in ("compute_s", "memory_s", "collective_s"))


def test_smoke_dense_forward_flops_counted_by_hand():
    """Prefill of a dense smoke model: every matmul of the forward, 2
    FLOPs a multiply-add, and nothing else."""
    cfg = smoke_config("qwen1.5-0.5b")
    B, S = 4, 32
    art = dryrun.build_cell("qwen1.5-0.5b", "p", "pod", cfg=cfg,
                            shape=ShapeCell("p", S, B, "prefill"))
    D, F, V, H = cfg.d_model, cfg.d_ff, cfg.padded_vocab, cfg.n_heads
    hd = cfg.resolved_head_dim
    T = B * S
    per_layer = (2 * T * D * (3 * H * hd)      # q, k, v
                 + 2 * T * D * (2 * H * hd)    # the cache's k, v again
                 + 2 * 2 * B * H * S * S * hd  # scores, probs @ v
                 + 2 * T * H * hd * D          # wo
                 + 3 * 2 * T * D * F)          # gate, up, down
    assert art["cost"]["flops"] == cfg.n_layers * per_layer + 2 * T * D * V


def test_dryrun_main_writes_artifacts(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "ART_DIR", tmp_path)
    assert dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k",
                        "--mesh", "both"]) == 0
    assert dryrun.main(["--arch", "qwen1.5-0.5b", "--shape",
                        "long_500k"]) == 0
    out = capsys.readouterr().out
    assert "SKIP-BY-DESIGN" in out and "done: 1 ok, 0 failed" in out
    for mesh in ("pod", "multipod"):
        art = json.loads(dryrun.cell_path("qwen1.5-0.5b", "decode_32k",
                                          mesh).read_text())
        assert art["ok"] and art["params"] == 463987712
        assert art["per_device_bytes"]["cache"] > 0
        assert art["roofline_terms"]["collective_s"] > 0
        assert art["collectives"]["counts"]["all-reduce"] > 0
