"""Collective counter: the collectives a DTensor program emits, with the
reference's byte rules.

The reference reads its collectives off the compiled, partitioned HLO
(``parse_collective_bytes`` in its dry run).  A DTensor program emits
its collectives as it runs: every redistribution (a ``shard_act``, a
``Partial`` reduced where an operation or an output placement needs it,
an all-gather in front of a local region) becomes a functional
collective on each rank's local tensor.  ``CollectiveCounter`` is a
``TorchDispatchMode`` that lets DTensor desugar first (it returns
``NotImplemented`` for DTensor operations) and so sees those
collectives, once each, with the local result's shape and the group's
size N.  A ``Partial`` is counted where it is materialised: a program
whose outputs are left ``Partial`` has run no reduction for them, so
the counter must stay on until the outputs are placed.  On a CPU mesh
DTensor moves a shard from one dim to another (``shard_dim_alltoall``)
by an all-gather and a slice, as gloo has no all-to-all; the counter
counts that all-gather as the all-to-all a CUDA mesh runs for the same
move (its result is the slice: the all-gather's result / N).

Per collective, as the reference's rules: all-gather: operand = result
/ N, wire = result (N-1)/N; reduce-scatter: operand = result N, wire =
result (N-1); all-reduce: operand = result, wire = 2 result (N-1)/N;
all-to-all: operand = result, wire = result (N-1)/N;
collective-permute (point to point, broadcast): operand = wire =
result.  Bytes are one device's.
"""
from __future__ import annotations

import math
import os
import sys

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

KINDS = ["all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute"]

# operation name (without its namespace and overload) -> kind
_KIND_OF = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
    "send": "collective-permute", "recv_": "collective-permute",
    "send_": "collective-permute",
}
_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d",
               "_dtensor")


def _nbytes(tree) -> int:
    from torch.utils._pytree import tree_flatten
    return sum(math.prod(t.shape) * t.element_size()
               for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor))


def _group_size(args, kwargs) -> int:
    """The size of a collective's group: of the process group it takes,
    else its ``group_size`` argument, else the group its ``group_name``
    names."""
    from torch.distributed import ProcessGroup
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in (*args, *kwargs.values()):
        if isinstance(a, ProcessGroup):
            return a.size()
    names = [a for a in (*args, *kwargs.values()) if isinstance(a, str)]
    sizes = kwargs.get("group_size")
    if sizes is None and names:
        return _resolve_process_group(names[-1]).size()
    if sizes is not None:
        return int(sizes)
    ints = [a for a in args if isinstance(a, int)]
    return ints[-1] if ints else 1


def program_site(types):
    """(whether an operation is DTensor's, not the program's; the
    program's function that ran it).  DTensor works out an operation's
    output placements and shapes by running it on fake or meta tensors
    of the global shapes (``_sharding_prop``), which is no device's
    work.  The site is the innermost function of the model or the
    trainer on the stack (``models/``, ``train/``), else the innermost
    of this package, else "autograd" (the engine runs a built-in
    operation's backward with no frame of the program's)."""
    if any(issubclass(t, FakeTensor) for t in types):
        return True, None
    model = own = None
    f = sys._getframe(2)  # the dispatch mode's caller
    while f is not None:
        name = f.f_code.co_filename
        if name.endswith(_PROPAGATOR):
            return True, None
        if model is None and name.startswith(_PKG):
            own = own or f.f_code.co_name
            if name.startswith(_MODEL):
                model = f.f_code.co_name
        f = f.f_back
    return False, model or own or "autograd"


_PROPAGATOR = os.path.join("distributed", "tensor", "_sharding_prop.py")
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep
_MODEL = tuple(os.path.join(_PKG, d) + os.sep for d in ("models", "train"))


def _in_shard_dim_alltoall() -> bool:
    """Whether DTensor's CPU fallback for an all-to-all is on the stack."""
    f = sys._getframe(1)
    while f is not None:
        if f.f_code.co_name == "shard_dim_alltoall":
            return True
        f = f.f_back
    return False


def stand_in_share(func, args, kwargs) -> int:
    """N where ``func`` is the all-gather a CPU mesh runs in place of an
    all-to-all over a group of N (its result is N times the
    all-to-all's), else 1."""
    if func.namespace in _NAMESPACES and _KIND_OF.get(
            func._schema.name.split("::")[-1]) == "all-gather" and \
            _in_shard_dim_alltoall():
        return max(1, _group_size(args, kwargs))
    return 1


def wire_rule(kind: str, rbytes: int, n: int) -> tuple:
    """(operand bytes, wire bytes) of one collective whose result is
    ``rbytes`` over a group of ``n``: the reference's rules."""
    if kind == "all-gather":
        return rbytes // max(1, n), rbytes * (n - 1) // max(1, n)
    if kind == "reduce-scatter":
        return rbytes * n, rbytes * (n - 1)
    if kind == "all-reduce":
        return rbytes, 2 * rbytes * (n - 1) // max(1, n)
    if kind == "all-to-all":
        return rbytes, rbytes * (n - 1) // max(1, n)
    return rbytes, rbytes  # collective-permute


class CollectiveCounter(TorchDispatchMode):
    """``with CollectiveCounter() as c: program()`` -> ``c.report()``, the
    reference's dict: ``bytes``, ``wire_bytes``, ``counts`` by kind,
    ``total_bytes``, ``total_wire_bytes``.  ``c.events`` lists each
    collective as (kind, group size, result bytes)."""

    def __init__(self):
        super().__init__()
        self.events: list = []
        self.sites: list = []  # the program's function of each event

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # let DTensor emit its collectives
        out = func(*args, **kwargs)
        if isinstance(func, torch._ops.HigherOrderOperator):
            return out
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns in _NAMESPACES and name in _KIND_OF:
            # an in-place collective's result is its tensor argument
            result = out if ns != "c10d" else args[0]
            kind, n = _KIND_OF[name], _group_size(args, kwargs)
            share = stand_in_share(func, args, kwargs)
            rbytes = _nbytes(result) // share
            if share > 1:
                kind = "all-to-all"
            self.events.append((kind, n, rbytes))
            self.sites.append(program_site(types)[1])
        return out

    def top_sites(self, n: int = 12) -> dict:
        """Operand bytes by "function kind" for the ``n`` largest: the
        program's function that issued each collective (DTensor issues a
        redistribution's where the function's operation needs it)."""
        total = {}
        for (kind, size, rbytes), site in zip(self.events, self.sites):
            key = f"{site} {kind}"
            total[key] = total.get(key, 0) + wire_rule(kind, rbytes, size)[0]
        return dict(sorted(total.items(), key=lambda kv: kv[1],
                           reverse=True)[:n])

    def report(self) -> dict:
        out = {k: 0 for k in KINDS}
        wire = {k: 0 for k in KINDS}
        counts = {k: 0 for k in KINDS}
        for kind, n, rbytes in self.events:
            operand, w = wire_rule(kind, rbytes, n)
            out[kind] += operand
            wire[kind] += w
            counts[kind] += 1
        return {"bytes": out, "wire_bytes": wire, "counts": counts,
                "total_bytes": sum(out.values()),
                "total_wire_bytes": sum(wire.values())}
