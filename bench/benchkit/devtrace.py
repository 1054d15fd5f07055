"""The device trace of a ``--trace 1`` window: torch.profiler over the
window (host and device activity), reduced to device intervals by name,
the busy time (their union), the idle gaps labelled by what the host was
doing (the innermost program span and the innermost host operation at
the gap's middle), and the window's own bounds.

Host times of the program's spans (``time.perf_counter``) are put on the
profiler's clock through the ``bench.window`` range, whose start is read
on both clocks.
"""
from __future__ import annotations

import re
import time

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12     # H100 SXM, dense bfloat16 (NVIDIA data sheet)
PEAK_HBM_BYTES = 3.35e12     # H100 SXM, HBM3


def _ns(ev, what: str) -> int:
    f = getattr(ev, what + "_ns", None)
    return int(f()) if f is not None else int(getattr(ev, what + "_us")()) * 1000


def short_name(name: str) -> str:
    name = re.sub(r"^void ", "", name)
    name = name.split("(")[0]
    return name[:96]


class DeviceTrace:
    """Start with ``begin()`` right before the window, ``end()`` after."""

    def __init__(self):
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA])
        self._range = None

    def begin(self) -> None:
        self.prof.__enter__()
        self._range = torch.profiler.record_function("bench.window")
        self._range.__enter__()
        self.host_t0 = time.perf_counter()

    def end(self) -> None:
        torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        cpu, dev = [], []
        for ev in self.prof.profiler.kineto_results.events():
            t0 = _ns(ev, "start")
            rec = (t0, t0 + _ns(ev, "duration"), ev.name())
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                if rec[2] != "bench.window":  # the range's device mirror
                    dev.append(rec)
            else:
                cpu.append(rec)
        win = next(r for r in cpu if r[2] == "bench.window")
        self.win0, self.win1 = win[0], win[1]
        self.window_s = (self.win1 - self.win0) / 1e9
        self.offset_ns = self.win0 - self.host_t0 * 1e9
        self.dev = [r for r in dev if r[1] > self.win0 and r[0] < self.win1]
        self.cpu = [r for r in cpu if r[2] != "bench.window"]
        self.busy_s, self.gaps = self._union()

    def _union(self):
        if not self.dev:
            return 0.0, []
        iv = sorted((max(a, self.win0), min(b, self.win1))
                    for a, b, _ in self.dev)
        busy, gaps = 0, []
        cur0, cur1 = iv[0]
        gaps.append((self.win0, cur0))
        for a, b in iv[1:]:
            if a > cur1:
                busy += cur1 - cur0
                gaps.append((cur1, a))
                cur0, cur1 = a, b
            else:
                cur1 = max(cur1, b)
        busy += cur1 - cur0
        gaps.append((cur1, self.win1))
        return busy / 1e9, [(a, b) for a, b in gaps if b > a]

    def kernel_seconds(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(b - a for a, b, n in self.dev if rx.search(n)) / 1e9

    def device_ops(self, top: int = 10) -> list:
        by: dict = {}
        for a, b, n in self.dev:
            k = short_name(n)
            by[k] = by.get(k, 0) + (b - a)
        return [[k, v / 1e9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, spans, top: int = 10, label_longest: int = 400
                  ) -> list:
        """Idle seconds summed by label, for the ``label_longest`` longest
        gaps (the rest summed as "other")."""
        gaps = sorted(self.gaps, key=lambda g: g[0] - g[1])
        sp = [(s.t0 * 1e9 + self.offset_ns,
               (s.t1 if s.t1 is not None else s.t0) * 1e9 + self.offset_ns,
               s.name) for s in spans]
        c0 = np.array([r[0] for r in self.cpu], np.int64)
        c1 = np.array([r[1] for r in self.cpu], np.int64)
        s0 = np.array([r[0] for r in sp], np.float64)
        s1 = np.array([r[1] for r in sp], np.float64)
        layers = ((s0, s1, [r[2] for r in sp], "no span"),
                  (c0, c1, [r[2] for r in self.cpu], "python"))
        by: dict = {}
        for i, (a, b) in enumerate(gaps):
            if i < label_longest:
                m = (a + b) / 2
                label = []
                for lo, hi, names, none in layers:
                    hit = np.nonzero((lo <= m) & (hi >= m))[0]
                    label.append(names[hit[np.argmin((hi - lo)[hit])]]
                                 if len(hit) else none)
                key = "/".join(label)
            else:
                key = "other"
            by[key] = by.get(key, 0) + (b - a)
        return [[k, v / 1e9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]
