"""Production mesh descriptions.

A ``Mesh`` names its axes and their sizes, and lists the devices it
spans; a *virtual* mesh has no devices and only describes a layout, the
counterpart of the reference forcing 512 host devices for its dry run.
Defined as functions, so importing this module never touches device
state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from repro_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...] = ()  # empty: a virtual mesh

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False, virtual: bool = False,
                         device="cuda") -> Mesh:
    """(data 16, model 16), or (pod 2, data 16, model 16) with
    ``multi_pod``.  Against real devices it needs 256 (512) cards and
    raises with fewer, as the reference's does; ``virtual=True`` gives
    the layout alone, for the dry run."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if virtual:
        return Mesh(axes, shape)
    n = math.prod(shape)
    devices = _devices(device)
    if len(devices) < n:
        raise RuntimeError(
            f"need {n} devices for mesh {shape}, found {len(devices)}; run "
            "under launch/dryrun.py (a virtual mesh) or on real hardware")
    return Mesh(axes, shape, tuple(devices[:n]))


def make_local_mesh(n_data: int = 1, n_model: int = 1,
                    device="cuda") -> Mesh:
    """Small mesh over the local devices of ``device``'s type (the CPU is
    one device)."""
    n = n_data * n_model
    devices = _devices(device)[:n]
    if len(devices) != n:
        raise RuntimeError(f"need {n} local devices, found {len(devices)}")
    return Mesh(("data", "model"), (n_data, n_model), tuple(devices))


def _devices(device) -> list:
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]
