"""Operation counter: the FLOPs and bytes of every operation that runs.

The counterpart of the reference's ``hlo_cost``.  XLA's own cost analysis
counts a while-loop's body once, so the reference expands loop trip
counts by hand over the compiled HLO.  The port runs its loops in Python,
so a ``TorchDispatchMode`` that sees every ATen operation as it executes
counts every trip by construction.  Run the step under ``OpCost`` on
meta tensors (``lm.abstract_params``, ``configs.input_specs``) and
nothing is computed or stored: only shapes flow.

- FLOPs: the matmul-class operations of torch's flop registry
  (``torch.utils.flop_counter``: mm, addmm, bmm, baddbmm, convolutions,
  fused attention), 2 per multiply-add.  Elementwise work adds none.
- bytes: each operation's tensor inputs read once and outputs written
  once; views move nothing and count 0.  As the reference's count at
  instruction granularity, this is what the operations touch without
  fusion, an upper bound on device-memory traffic.
"""
from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry


def _nbytes(tree) -> int:
    return sum(math.prod(t.shape) * t.element_size()
               for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor))


class OpCost(TorchDispatchMode):
    """``with OpCost() as c: step(...)`` -> ``c.flops``, ``c.bytes``."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not func.is_view:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def analyze(fn, *args, **kwargs) -> OpCost:
    """Run ``fn(*args, **kwargs)`` under a fresh ``OpCost`` and return
    it."""
    with OpCost() as cost:
        fn(*args, **kwargs)
    return cost
