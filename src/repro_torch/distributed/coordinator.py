"""Cross-process scheduling: several ``QueryScheduler``s, one dispatch lane.

A ``DispatchCoordinator`` owns a single strict-FIFO
``AsyncOracleDispatcher`` worker and hands out ``CoordinatedLane``s.  A
``QueryScheduler`` constructed with ``coordinator=`` (or a ``Session``
built with one — see ``repro_torch.api.Session``) routes every merged dispatch
wave through its lane instead of a private dispatcher, so all attached
schedulers' waves drain through ONE serving lane:

- **per-scheduler determinism is untouched** — a lane forwards waves in
  the order its scheduler submits them, and the shared worker is strict
  FIFO, so within one scheduler the evaluation order is exactly what a
  private dispatcher would produce (bit-identity per query holds);
- **cross-scheduler waves interleave at wave granularity** — distinct
  sessions share no oracle objects or RNG state, so interleaving whole
  waves is observable only as bigger engine utilization, never as a
  result change;
- **lifecycle is decoupled** — ``lane.close()`` detaches the scheduler
  (after its in-flight waves drain) without stopping the shared worker;
  ``coordinator.close()`` shuts the worker down once every scheduler has
  detached (or force-closes remaining lanes).

In-process stand-in for the multi-host arrangement: one coordinator per
serving host, one scheduler per tenant process, the lane boundary being
where an RPC hop would slot in.  See docs/distributed.md.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional

from repro_torch.core.oracle import AsyncOracleDispatcher
from repro_torch.obs.trace import get_tracer


@dataclasses.dataclass
class LaneStats:
    """Per-attached-scheduler accounting, kept after detach."""
    label: str
    n_waves: int = 0
    n_calls: int = 0     # submit_call invocations (waves + direct calls)
    attached: bool = True


class CoordinatedLane:
    """The dispatcher-shaped handle a scheduler drives.

    Implements the subset of the ``AsyncOracleDispatcher`` surface the
    scheduler uses (``submit_call``/``close``); ``close()`` detaches from
    the coordinator instead of stopping the shared worker.
    """

    def __init__(self, coordinator: "DispatchCoordinator", lane_id: int,
                 label: str):
        self._coordinator = coordinator
        self.lane_id = lane_id
        self.label = label
        self._detached = False

    def submit_call(self, fn, *args):
        """Queue ``fn(*args)`` on the shared FIFO worker."""
        if self._detached:
            raise RuntimeError(f"lane {self.label!r} is detached")
        return self._coordinator._submit_call(self.lane_id, fn, *args)

    def close(self) -> None:
        """Detach: wait for this lane's queued waves to drain, then drop
        the attachment.  The shared worker keeps serving other lanes."""
        if self._detached:
            return
        self._detached = True
        self._coordinator._detach(self.lane_id)

    def __repr__(self):
        state = "detached" if self._detached else "attached"
        return f"CoordinatedLane({self.label!r}, {state})"


class DispatchCoordinator:
    """One merged dispatch lane shared by several schedulers."""

    def __init__(self):
        self._lock = threading.Lock()
        self._worker = AsyncOracleDispatcher()
        self._lanes: Dict[int, LaneStats] = {}
        self._next_id = 0
        self._closed = False
        self.n_waves = 0

    # ----------------------------------------------------------- attach
    def attach(self, label: Optional[str] = None) -> CoordinatedLane:
        """Create a lane for one scheduler (``QueryScheduler`` calls this
        when constructed with ``coordinator=``)."""
        with self._lock:
            if self._closed:
                raise RuntimeError("coordinator is closed")
            lane_id = self._next_id
            self._next_id += 1
            self._lanes[lane_id] = LaneStats(
                label=label or f"lane{lane_id}")
            get_tracer().metrics.set("coordinator.lanes",
                                     self.n_attached)
        return CoordinatedLane(self, lane_id, self._lanes[lane_id].label)

    def _submit_call(self, lane_id: int, fn, *args):
        with self._lock:
            if self._closed:
                raise RuntimeError("coordinator is closed")
            st = self._lanes[lane_id]
            st.n_calls += 1
            st.n_waves += 1
            self.n_waves += 1
        get_tracer().metrics.inc("coordinator.waves")
        return self._worker.submit_call(fn, *args)

    def _detach(self, lane_id: int) -> None:
        # barrier: everything this lane queued has been evaluated before
        # detach returns, mirroring AsyncOracleDispatcher.close() semantics
        # (the scheduler relies on close() meaning "drained")
        self._worker.submit_call(lambda: None).result()
        with self._lock:
            self._lanes[lane_id].attached = False
            get_tracer().metrics.set("coordinator.lanes", self.n_attached)

    # ------------------------------------------------------------ status
    @property
    def n_attached(self) -> int:
        return sum(1 for st in self._lanes.values() if st.attached)

    def stats(self) -> Dict[str, LaneStats]:
        """Per-lane wave counts keyed by label (detached lanes included)."""
        with self._lock:
            return {st.label: dataclasses.replace(st)
                    for st in self._lanes.values()}

    def close(self) -> None:
        """Stop the shared worker after draining queued waves.  Lanes
        still attached are force-detached (their next submit raises)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for st in self._lanes.values():
                st.attached = False
        self._worker.close()
