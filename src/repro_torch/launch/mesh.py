"""Meshes: named axes over a process group.

A ``Mesh`` names its axes and their sizes and, when it stands over a
process group, carries the ``torch.distributed`` ``DeviceMesh`` that
DTensor placements refer to.  A layout-only mesh (``device_mesh`` None)
describes a layout and places nothing: tensors stay plain.

- ``make_local_mesh`` builds a ``DeviceMesh`` over the initialised
  process group (one NCCL rank on one card, or gloo ranks on the CPU);
  it raises without a group of exactly the mesh's size.
- ``make_production_mesh`` is (data 16, model 16) or (pod 2, data 16,
  model 16): over a group of 256 (512) ranks, or ``virtual=True`` for the
  layout alone.
- ``virtual_device_mesh`` stands a mesh over a ``fake`` process group of
  ``mesh.size`` ranks in this process, for the dry run: DTensor programs
  then run on one rank's shards, and their collectives run and are
  counted but move nothing.

Defined as functions, so importing this module never touches device
state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch.distributed as dist

from repro_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    device_mesh: Any = None  # a DeviceMesh; None for a layout-only mesh

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def _over_group(mesh: Mesh, device_type: str) -> Mesh:
    """``mesh`` with a ``DeviceMesh`` over the default process group,
    which must have exactly ``mesh.size`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh {mesh.shape} needs an initialised process group of "
            f"{mesh.size} ranks (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if world != mesh.size:
        raise RuntimeError(f"mesh {mesh.shape} needs {mesh.size} ranks, the "
                           f"process group has {world}")
    dm = init_device_mesh(device_type, mesh.axis_sizes,
                          mesh_dim_names=mesh.axis_names)
    return dataclasses.replace(mesh, device_mesh=dm)


def make_production_mesh(*, multi_pod: bool = False, virtual: bool = False,
                         device="cuda") -> Mesh:
    """(data 16, model 16), or (pod 2, data 16, model 16) with
    ``multi_pod``.  Over a process group it needs 256 (512) ranks and
    raises with fewer, as the reference's does; ``virtual=True`` gives
    the layout alone."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    mesh = Mesh(axes, shape)
    if virtual:
        return mesh
    dev = resolve_device(device)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < mesh.size:
        raise RuntimeError(
            f"need {mesh.size} devices for mesh {shape}, found {have}; run "
            "under launch/dryrun.py (a virtual mesh) or on real hardware")
    return _over_group(mesh, dev.type)


def make_local_mesh(n_data: int = 1, n_model: int = 1,
                    device="cuda") -> Mesh:
    """(data ``n_data``, model ``n_model``) over the initialised process
    group, whose world size must be ``n_data * n_model``; the ranks'
    tensors live on ``device``'s type."""
    dev = resolve_device(device)
    return _over_group(Mesh(("data", "model"), (n_data, n_model)), dev.type)


def virtual_device_mesh(mesh: Mesh) -> Mesh:
    """``mesh`` over a ``fake`` process group of ``mesh.size`` ranks, made
    here as this process's default group (this process is rank 0).  The
    group is the dry run's alone: it raises if another default group
    exists, and the caller destroys it
    (``torch.distributed.destroy_process_group``) when done.  The
    program's local shards are meta tensors, so no card is needed; the
    ``DeviceMesh`` is of type "cpu", where DTensor's own fake propagation
    runs on any build (``launch.collectives`` counts the all-gather that
    DTensor runs there in place of an all-to-all as the all-to-all the
    card would run)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError(
            "virtual_device_mesh makes this process's default group, and "
            f"one exists ({dist.get_backend()}, {dist.get_world_size()} "
            "ranks): run the dry run in its own process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        return _over_group(Mesh(mesh.axis_names, mesh.axis_sizes), "cpu")
    except BaseException:
        dist.destroy_process_group()
        raise
