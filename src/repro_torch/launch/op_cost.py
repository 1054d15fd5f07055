"""Operation counter: the FLOPs and bytes of every operation that runs,
and the peak of the bytes its results hold.

The counterpart of the reference's ``hlo_cost``.  XLA's own cost analysis
counts a while-loop's body once, so the reference expands loop trip
counts by hand over the compiled HLO.  The port runs its loops in Python,
so a ``TorchDispatchMode`` that sees every ATen operation as it executes
counts every trip by construction.  Run the step under ``OpCost`` on
meta or fake tensors (``lm.abstract_params``, ``configs.input_specs``)
and nothing is computed or stored: only shapes flow.

- FLOPs: the matmul-class operations of torch's flop registry
  (``torch.utils.flop_counter``: mm, addmm, bmm, baddbmm, convolutions,
  fused attention), 2 per multiply-add.  Elementwise work adds none.
- bytes: each operation's tensor inputs read once and outputs written
  once; views move nothing and count 0.  As the reference's count at
  instruction granularity, this is what the operations touch without
  fusion, an upper bound on device-memory traffic.
- peak bytes: the most bytes that the storages made under the counter
  hold at once (a storage counts from the operation that makes it until
  its last tensor is freed); the arguments the program was given
  (``OpCost(given=...)``) are not among them, even where it writes
  into them in place.

On a DTensor program the counter lets DTensor desugar first (it returns
``NotImplemented`` for DTensor operations) and counts the operations on
each rank's local shards: one device's FLOPs, bytes and peak, replicated
work included.  DTensor's own shape propagation, which runs operations
on fake or meta tensors of the global shapes, is not counted.  Where a
CPU mesh stands in for an all-to-all with an all-gather
(``launch.collectives``), the gathered result counts as the all-to-all's
(1/N of it), in bytes and in the peak.
"""
from __future__ import annotations

import math
import os
import sys
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.launch.collectives import stand_in_share


def _propagation(types) -> bool:
    """Whether an operation is DTensor's, not the program's: DTensor works
    out an operation's output placements and shapes by running it on
    fake or meta tensors of the global shapes (``_sharding_prop``), which
    is no device's work."""
    if any(issubclass(t, FakeTensor) for t in types):
        return True
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith(_PROPAGATOR):
            return True
        f = f.f_back
    return False


_PROPAGATOR = os.path.join("distributed", "tensor", "_sharding_prop.py")


def _nbytes(tree) -> int:
    return sum(math.prod(t.shape) * t.element_size()
               for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor))


class OpCost(TorchDispatchMode):
    """``with OpCost() as c: step(...)`` -> ``c.flops``, ``c.bytes``,
    ``c.peak_bytes``."""

    def __init__(self, given=()):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._seen = WeakIdKeyDictionary()
        for t in tree_flatten(given)[0]:
            if isinstance(t, DTensor):
                t = t.to_local()
            if isinstance(t, torch.Tensor):
                self._seen[t.untyped_storage()] = 0

    def _free(self, nbytes: int) -> None:
        self.live_bytes -= nbytes

    def _track(self, out, share: int = 1) -> None:
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor) or isinstance(t, DTensor):
                continue
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes() // share
            self._seen[st] = n
            weakref.finalize(st, self._free, n)
            self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # count the local operations instead
        out = func(*args, **kwargs)
        if isinstance(func, torch._ops.HigherOrderOperator) or \
                _propagation(types):
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not func.is_view:
            share = stand_in_share(func, args, kwargs)
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out) // share
            self._track(out, share)
        return out


def analyze(fn, *args, **kwargs) -> OpCost:
    """Run ``fn(*args, **kwargs)`` under a fresh ``OpCost`` and return
    it."""
    with OpCost() as cost:
        fn(*args, **kwargs)
    return cost
