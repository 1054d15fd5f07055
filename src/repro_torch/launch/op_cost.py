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
- by site: FLOPs and bytes by the program's function that ran each
  operation and the operation (``by_site``), and the bytes each
  function's storages held at the peak (``peak_by_site``);
  ``top_sites`` gives the largest.

A loop body that runs many times on meta tensors of the same shapes
(the chunked attention's blocks, a prefill's thousands a layer) is
marked ``@replayed(...)``: under a counter, on meta tensors and without
gradients, its first call with a given signature runs and is recorded,
and a later call with the same signature adds the recorded FLOPs,
bytes and rise of the live bytes to the counter and returns new meta
tensors of the recorded outputs' shapes.  The counts are the same as
running every call (meta operations' results depend on shapes alone);
only the Python work of running them goes.

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

import functools
import math
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.launch.collectives import program_site, stand_in_share


def _nbytes(tree) -> int:
    return sum(math.prod(t.shape) * t.element_size()
               for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor))


class OpCost(TorchDispatchMode):
    """``with OpCost() as c: step(...)`` -> ``c.flops``, ``c.bytes``,
    ``c.peak_bytes``."""

    def __init__(self, given=(), replay: bool = True):
        super().__init__()
        self.replay = replay  # whether ``@replayed`` calls may replay
        self._tapes = {}  # signature -> what one call added
        self._high = None  # the most live bytes while a call is recorded
        self.flops = 0
        self.bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.by_site = {}  # "function aten.op" -> [flops, bytes]
        self._live_site = {}  # function -> bytes its storages hold now
        self.peak_by_site = {}  # the same at the peak
        self._seen = WeakIdKeyDictionary()
        for t in tree_flatten(given)[0]:
            if isinstance(t, DTensor):
                t = t.to_local()
            if isinstance(t, torch.Tensor):
                self._seen[t.untyped_storage()] = 0

    def _free(self, nbytes: int, site: str) -> None:
        self.live_bytes -= nbytes
        self._live_site[site] -= nbytes

    def _track(self, out, site: str, share: int = 1) -> None:
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor) or isinstance(t, DTensor):
                continue
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes() // share
            self._seen[st] = n
            weakref.finalize(st, self._free, n, site)
            self.live_bytes += n
            self._live_site[site] = self._live_site.get(site, 0) + n
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes
            self.peak_by_site = _held(self._live_site)
        if self._high is not None and self.live_bytes > self._high[0]:
            self._high = (self.live_bytes, _held(self._live_site))

    def _record(self, key, fn, args):
        """Run ``fn(*args)`` and keep what it added to the counts."""
        flops, nbytes = self.flops, self.bytes
        sites = {k: list(v) for k, v in self.by_site.items()}
        live, live_site = self.live_bytes, dict(self._live_site)
        self._high = (live, live_site)
        try:
            out = fn(*args)
            high, high_site = self._high
        finally:
            self._high = None
        leaves, spec = tree_flatten(out)
        self._tapes[key] = dict(
            flops=self.flops - flops, bytes=self.bytes - nbytes,
            sites={k: (v[0] - sites.get(k, (0, 0))[0],
                       v[1] - sites.get(k, (0, 0))[1])
                   for k, v in self.by_site.items()
                   if tuple(v) != tuple(sites.get(k, (0, 0)))},
            rise=high - live,
            rise_site={k: v - live_site.get(k, 0)
                       for k, v in high_site.items()},
            out=(spec, [(tuple(t.shape), t.stride(), t.dtype)
                        if isinstance(t, torch.Tensor) else t
                        for t in leaves]))
        return out

    def _replay(self, tape, site):
        """Add a recorded call's counts; new meta tensors for its
        outputs."""
        self.flops += tape["flops"]
        self.bytes += tape["bytes"]
        for k, (f, b) in tape["sites"].items():
            entry = self.by_site.setdefault(k, [0, 0])
            entry[0] += f
            entry[1] += b
        if self.live_bytes + tape["rise"] > self.peak_bytes:
            self.peak_bytes = self.live_bytes + tape["rise"]
            self.peak_by_site = _held({
                k: self._live_site.get(k, 0) + tape["rise_site"].get(k, 0)
                for k in set(self._live_site) | set(tape["rise_site"])})
        spec, leaves = tape["out"]
        with _disable_current_modes():
            leaves = [torch.empty_strided(t[0], t[1], dtype=t[2],
                                          device="meta")
                      if isinstance(t, tuple) else t for t in leaves]
        self._track(leaves, site)
        return tree_unflatten(leaves, spec)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # count the local operations instead
        out = func(*args, **kwargs)
        if isinstance(func, torch._ops.HigherOrderOperator):
            return out
        propagation, site = program_site(types)
        if propagation:
            return out
        packet = func._overloadpacket
        flops = nbytes = 0
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
        if not func.is_view:
            share = stand_in_share(func, args, kwargs)
            nbytes = _nbytes((args, kwargs)) + _nbytes(out) // share
            self._track(out, site, share)
        if flops or nbytes:
            self.flops += flops
            self.bytes += nbytes
            entry = self.by_site.setdefault(f"{site} {packet}", [0, 0])
            entry[0] += flops
            entry[1] += nbytes
        return out

    def top_sites(self, n: int = 12) -> dict:
        """The ``n`` sites with the most FLOPs, with the most bytes, and
        with the most bytes held at the peak."""
        top = lambda d, key: dict(sorted(  # noqa: E731
            d.items(), key=key, reverse=True)[:n])
        return {"flops": top({k: v[0] for k, v in self.by_site.items()},
                             lambda kv: kv[1]),
                "bytes": top({k: v[1] for k, v in self.by_site.items()},
                             lambda kv: kv[1]),
                "peak": top(self.peak_by_site, lambda kv: kv[1])}


def _held(live: dict) -> dict:
    return {k: v for k, v in live.items() if v}


def _signature(a):
    if isinstance(a, torch.Tensor):
        return (tuple(a.shape), a.stride(), a.dtype)
    return a


def replayed(*ignore: int):
    """Decorator of a loop body whose counts depend on its arguments'
    shapes alone (the positions in ``ignore``, a loop index say, not at
    all): under an ``OpCost`` (``replay`` on), where every tensor
    argument is a meta tensor and no gradient is recorded, a call whose
    signature the counter has seen before replays the first one's
    counts (see the module's notes); otherwise the function runs as
    written."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args):
            cost = next((m for m in reversed(
                _get_current_dispatch_mode_stack())
                if isinstance(m, OpCost)), None)
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            if cost is None or not cost.replay or cost._high is not None \
                    or not all(t.is_meta for t in tensors) or (
                        torch.is_grad_enabled()
                        and any(t.requires_grad for t in tensors)):
                return fn(*args)
            key = (fn, *(_signature(a) for i, a in enumerate(args)
                         if i not in ignore))
            tape = cost._tapes.get(key)
            if tape is None:
                return cost._record(key, fn, args)
            return cost._replay(tape, fn.__name__)
        return run
    return wrap


def analyze(fn, *args, **kwargs) -> OpCost:
    """Run ``fn(*args, **kwargs)`` under a fresh ``OpCost`` and return
    it."""
    with OpCost() as cost:
        fn(*args, **kwargs)
    return cost
