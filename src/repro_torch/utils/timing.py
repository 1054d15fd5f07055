"""Timing helpers: the port's single source of duration clocks.

Every duration measurement routes through ``monotonic()``
(``time.perf_counter`` — monotonic, immune to wall-clock steps/NTP slews).
``cuda_event_ms`` and ``device_ms`` replace the reference's ``time_jax``:
PyTorch returns before the device finishes, so a host clock around device
work measures only the enqueue; CUDA events time the device work itself.
``cuda_event_ms`` brackets one call, so when the card waits for the host
its time includes the caller's host work; ``device_ms`` keeps the host
ahead of the card and times the device work alone.
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


def device_ms(fn, arg_sets, *, calls: int = 20, reps: int = 5):
    """Device milliseconds a call of fn, with the host ahead of the card.

    A spin kernel (``torch.cuda._sleep``) holds the card while the host
    enqueues ``calls`` back-to-back calls between one event pair, so the
    pair brackets device work and not the host work of each call.  The
    calls cycle through ``arg_sets`` (a list of argument tuples): inputs
    rotated through more bytes than the L2 cache are read from device
    memory, as a model's per-layer inputs are.  The spin lasts twice the
    host time of one unspun batch.

    Returns (median over ``reps`` batches of batch ms / calls, ahead):
    ``ahead`` is False when the host took longer to enqueue a batch than
    the spin lasted (a call that synchronises, for example), and then the
    time includes host work.  Needs a CUDA device.
    """
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    t0 = monotonic()
    for i in range(calls):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    cycles = int(2 * (monotonic() - t0) * 2e9)   # an H100 clocks ~2 GHz
    ms, ahead = [], True
    for _ in range(reps):
        s0, s1, a, b = (torch.cuda.Event(enable_timing=True)
                        for _ in range(4))
        s0.record()
        torch.cuda._sleep(cycles)
        s1.record()
        a.record()
        t0 = monotonic()
        for i in range(calls):
            fn(*arg_sets[i % len(arg_sets)])
        host_ms = (monotonic() - t0) * 1e3
        b.record()
        torch.cuda.synchronize()
        ahead = ahead and host_ms < s0.elapsed_time(s1)
        ms.append(a.elapsed_time(b) / calls)
    return sorted(ms)[reps // 2], ahead


def profiler_ms(fn, arg_sets, kernel: str, *, calls: int = 20) -> float:
    """Median device milliseconds of one launch of the kernel whose name
    contains ``kernel``, read from torch.profiler over ``calls`` calls of
    fn cycling through ``arg_sets``.  Host work inside fn (copies, a
    synchronise) does not count, as it does in ``device_ms``.  Needs a
    CUDA device; raises if the trace holds no launch of that kernel.
    """
    from torch.profiler import ProfilerActivity, profile

    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(*arg_sets[i % len(arg_sets)])
        torch.cuda.synchronize()
    us = sorted(e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and kernel in e.name)
    if not us:
        raise RuntimeError(f"the profiler recorded no launch of {kernel}")
    return us[len(us) // 2] / 1e3
