"""Timing helpers: the port's single source of duration clocks.

Every duration measurement routes through ``monotonic()``
(``time.perf_counter`` — monotonic, immune to wall-clock steps/NTP slews).
``cuda_event_ms`` replaces the reference's ``time_jax``: PyTorch returns
before the device finishes, so a host clock around device work measures
only the enqueue; CUDA events time the device work itself.
"""
from __future__ import annotations

import time

import torch


def monotonic() -> float:
    """Monotonic seconds for measuring durations (``t1 - t0``).

    The value is only meaningful as a difference against another
    ``monotonic()`` reading — never as a wall-clock date.
    """
    return time.perf_counter()


class Timer:
    def __init__(self):
        self.start = None
        self.elapsed = 0.0

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        return False


def cuda_event_ms(fn, *args, warmup: int = 3, iters: int = 20) -> float:
    """Median device milliseconds of fn(*args), timed with CUDA events.

    One event pair per call; the median over ``iters`` calls after
    ``warmup`` untimed calls.  Needs a CUDA device.
    """
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    stops = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for a, b in zip(starts, stops):
        a.record()
        fn(*args)
        b.record()
    torch.cuda.synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in zip(starts, stops))
    return ms[len(ms) // 2]
