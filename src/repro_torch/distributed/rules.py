"""Logical-axis -> mesh-axis resolution (MaxText-style, with divisibility
fallback), the reference's rules over a mesh description.

Parameters and activations are annotated with *logical* axis names
("vocab", "heads", "ffn", "embed", "experts", ...).  ``MeshRules`` maps
each logical name to an ordered list of candidate mesh axes; resolution
walks a leaf's logical axes and greedily assigns the first candidate mesh
axis that (a) is not already used by another dim of the same leaf and
(b) evenly divides the dim size.  Rules that do not fit are *dropped with
a recorded warning* instead of failing — e.g. whisper-base's 8 heads
cannot be sharded over a 16-way "model" axis and fall back to
replication.

A mesh is anything with a ``shape`` mapping axis names to sizes, in
mesh order (``repro_torch.launch.mesh.Mesh``, or a plain dict); a spec
is the reference's partition tuple: per dim a mesh axis, a tuple of
axes, or None.  ``placements`` turns a spec into DTensor placements, one
per mesh dim, the form a ``DeviceMesh`` takes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

from torch.distributed.tensor import Replicate, Shard

# logical name -> ordered candidate mesh-axis tuples.  Each candidate is a
# tuple of mesh axes (sharding one dim over multiple mesh axes is allowed,
# e.g. kv_seq over ("data","model") for 500k decode).
DEFAULT_LOGICAL_RULES: Dict[str, List[Tuple[str, ...]]] = {
    # weights
    "vocab": [("model",)],
    "heads": [("model",)],
    "kv_heads": [("model",)],
    "ffn": [("model",)],
    "experts": [("model",)],
    "inner": [("model",)],  # mamba d_inner
    "embed": [("data",)],  # FSDP / ZeRO-3 axis
    # activations
    "batch": [("pod", "data"), ("data",)],
    "act_embed": [],
    "seq": [],
    "kv_seq": [("model",)],
    "kv_seq_long": [("data", "model"), ("model",)],
    "kv_batch": [("pod", "data"), ("data",)],
}


def _mesh_shape(mesh) -> Dict[str, int]:
    return dict(mesh if isinstance(mesh, dict) else mesh.shape)


@dataclasses.dataclass
class MeshRules:
    mesh: Any
    rules: Dict[str, List[Tuple[str, ...]]] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_LOGICAL_RULES))
    warnings: List[str] = dataclasses.field(default_factory=list)

    def _axis_size(self, axes: Tuple[str, ...]) -> Optional[int]:
        shape = _mesh_shape(self.mesh)
        try:
            return int(math.prod(shape[a] for a in axes))
        except KeyError:
            return None  # mesh lacks one of the axes (e.g. "pod" on single pod)

    def _resolve_dim(self, name: Optional[str], dim: int, used: set):
        if name is None or name not in self.rules:
            return None
        for cand in self.rules[name]:
            size = self._axis_size(cand)
            if size is None:
                continue
            if any(a in used for a in cand):
                continue
            if dim % size != 0:
                self.warnings.append(
                    f"drop {name}->{cand}: dim {dim} % {size} != 0")
                continue
            used.update(cand)
            return cand if len(cand) > 1 else cand[0]
        return None

    def spec(self, logical_axes: Sequence[Optional[str]],
             shape: Sequence[int]) -> tuple:
        if len(logical_axes) != len(shape):
            raise ValueError(f"axes {logical_axes} for shape {shape}")
        used: set = set()
        return tuple(self._resolve_dim(n, d, used)
                     for n, d in zip(logical_axes, shape))

    # activations may carry fewer constraints; identical mechanics
    activation_spec = spec

    def placements(self, spec: tuple) -> tuple:
        """One DTensor placement per mesh dim: ``Shard(d)`` where tensor
        dim d is split over that mesh axis, ``Replicate()`` elsewhere.  A
        dim split over several axes (("pod", "data"), say) is sharded on
        each; the first named is the major one, as in the reference's
        ``PartitionSpec``, which is DTensor's order when the axes come in
        mesh order (the rules' candidates all do)."""
        names = list(_mesh_shape(self.mesh))
        out = [Replicate()] * len(names)
        for d, part in enumerate(spec):
            if part is None:
                continue
            idx = [names.index(a)
                   for a in (part if isinstance(part, tuple) else (part,))]
            if idx != sorted(idx):
                raise ValueError(f"spec {spec}: axes of dim {d} are not in "
                                 f"mesh order {names}")
            for i in idx:
                out[i] = Shard(d)
        return tuple(out)

    def shard_shape(self, spec: tuple, shape: Sequence[int]) -> tuple:
        """One device's block of a tensor of ``shape`` under ``spec``."""
        return tuple(
            d if part is None else
            d // self._axis_size(part if isinstance(part, tuple) else (part,))
            for part, d in zip(spec, shape))


def resolve_spec(mesh, logical_axes, shape) -> tuple:
    return MeshRules(mesh).spec(logical_axes, shape)
