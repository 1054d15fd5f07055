"""The partitioned program on the card: a one-rank NCCL group, mesh (data
1, model 1).

Marked ``cuda``; each test skips without a GPU.  The smoke train step of
a dense and a MoE + Mamba model, its parameters, optimizer state and
batch placed as DTensors by their logical axes, equals the unpartitioned
step on the card bit for bit (on one rank every block is the whole
tensor and every collective moves nothing, so the same kernels run on
the same values); a bf16 model takes the vocab product's local region.
A checkpoint saved unsharded restores onto the mesh exactly, and one
saved from the mesh is the same file.  No JAX is needed:

    python -m pytest tests/test_torch_sharded_card.py -m cuda
"""
import datetime

import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import input_logical_axes, smoke_config
from repro_torch.distributed.api import (distribute_tree, gather_tree,
                                         sharding_context, tree_placements)
from repro_torch.distributed.rules import MeshRules
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import lm
from repro_torch.train import OptConfig, adamw_init, make_train_step
from repro_torch.train.optimizer import opt_logical_axes
from repro_torch.utils.tree import tree_leaves_with_path


@pytest.fixture
def mesh(tmp_path):
    """(data 1, model 1) over a one-rank NCCL group, destroyed after."""
    import os

    import torch.distributed as dist
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # no network
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        yield make_local_mesh(1, 1, device="cuda")
    finally:
        dist.destroy_process_group()


def _state(cfg, oc):
    params = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")
    return params, adamw_init(params, oc)


def _axes(cfg, oc):
    axes = {"params": lm.param_logical_axes(cfg)}
    axes["opt"] = opt_logical_axes(axes["params"], oc)
    return axes


def _equal(a, b, where):
    a, b = dict(tree_leaves_with_path(a)), dict(tree_leaves_with_path(b))
    assert a.keys() == b.keys(), where
    for k in a:
        assert torch.equal(a[k], b[k]), (where, k)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,dtype", [("qwen1.5-0.5b", "float32"),
                                        ("qwen1.5-0.5b", "bfloat16"),
                                        ("jamba-v0.1-52b", "float32")])
def test_partitioned_step_equals_the_unpartitioned_step(mesh, arch, dtype):
    cfg = smoke_config(arch).replace(dtype=dtype)
    oc = OptConfig(lr=3e-3, warmup_steps=2, total_steps=50)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 33), generator=g).cuda()
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    step = make_train_step(cfg, oc)
    params, opt = _state(cfg, oc)
    want = step(params, opt, batch)
    rules = MeshRules(mesh)
    with sharding_context(rules):
        state = distribute_tree({"params": params, "opt": opt},
                                _axes(cfg, oc), rules)
        got = step(state["params"], state["opt"],
                   distribute_tree(batch, input_logical_axes(batch), rules))
        got = gather_tree(got)
    _equal(want, got, f"{arch} {dtype}")


@pytest.mark.cuda
def test_elastic_restore_on_the_card_is_exact(mesh, tmp_path):
    cfg = smoke_config("jamba-v0.1-52b")
    oc = OptConfig()
    params, opt = _state(cfg, oc)
    tree = {"params": params, "opt": opt}
    CheckpointManager(tmp_path / "whole").save(3, tree)
    rules = MeshRules(mesh)
    axes = _axes(cfg, oc)
    with sharding_context(rules):
        placed = distribute_tree(tree, axes, rules)
        step, got, _ = CheckpointManager(tmp_path / "whole").restore(
            tree, tree_placements(placed, axes, rules))
        assert step == 3
        _equal(tree, gather_tree(got), "restored onto the mesh")
        CheckpointManager(tmp_path / "mesh").save(3, got)
    (a,), (b,) = ((tmp_path / d / "step_00000003").glob("shard_*")
                  for d in ("whole", "mesh"))
    assert a.read_bytes() == b.read_bytes()
