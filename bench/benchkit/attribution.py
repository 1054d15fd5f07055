"""Device time by the program span that launched it.

Each device kernel of the traced window (every device event but the
profiler's mirrors of ``record_function`` ranges) is joined by its
correlation id to the host runtime or driver call that launched it (a
host event named ``cu*``: CPU operators count correlation ids of their
own, which can collide, and the card's torch 2.11 gives no event type),
and the
launch's start is put in the innermost of the named program spans whose
host interval holds it.  Span times (``time.perf_counter``) go onto the
profiler's clock through ``repro_torch.obs.trace.epoch_ns``.  Where spans
of two threads overlap in time a launch could belong to either, so the
sums are None: nothing is guessed.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

LAYER_KINDS = ("attn", "mamba", "moe", "mlp")


def kernels(events, win0: int, win1: int, names: bool = False):
    """(launch_ns, device_ns) arrays over the device kernels that overlap
    [win0, win1] (profiler ns): the start of the host runtime call of the
    same correlation id, -1 where none was recorded, and the kernel's
    device time; with ``names``, the kernels' names as a third array."""
    launch, dev = {}, []
    for ev in events:
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if ev.is_user_annotation():
                continue
            t0 = ev.start_ns()
            d = ev.duration_ns()
            if t0 + d > win0 and t0 < win1:
                dev.append((ev.correlation_id(), d, ev.name()))
        elif ev.name().startswith("cu"):  # cudaLaunchKernel, cuLaunchKernel, ...
            launch[ev.correlation_id()] = ev.start_ns()
    at = np.array([launch.get(c, -1) for c, _, _ in dev], np.int64)
    out = (at, np.array([d for _, d, _ in dev], np.int64))
    return out + (np.array([n for _, _, n in dev], object),) if names else out


def _threads_overlap(spans) -> bool:
    end: dict = {}
    for s in sorted(spans, key=lambda s: s.t0):
        if any(t1 > s.t0 for th, t1 in end.items() if th != s.thread):
            return True
        end[s.thread] = max(end.get(s.thread, s.t1), s.t1)
    return False


def innermost(launch_ns, spans, names, to_ns=None):
    """(sel, idx): the spans among ``names`` sorted by start, and for each
    launch the index in ``sel`` of the innermost of them whose host
    interval holds it (-1 for none, or a launch never seen), or None where
    spans of two threads overlap.  ``to_ns`` maps span times onto the
    launches' clock (default ``epoch_ns``)."""
    if to_ns is None:
        from repro_torch.obs.trace import epoch_ns as to_ns
    sel = sorted((s for s in spans if s.name in names and s.t1 is not None),
                 key=lambda s: (s.t0, -s.t1))
    if _threads_overlap(sel):
        return None
    if not sel or not len(launch_ns):
        return sel, np.full(len(launch_ns), -1)
    t = to_ns(np.array([s.t0 for s in sel] + [s.t1 for s in sel]))
    t0, t1 = t[:len(sel)], t[len(sel):]
    enclosing = np.full(len(sel), -1)   # the span each one nests in
    stack: list = []
    for i in range(len(sel)):
        while stack and t1[stack[-1]] < t0[i]:
            stack.pop()
        if stack:
            enclosing[i] = stack[-1]
        stack.append(i)
    idx = np.searchsorted(t0, launch_ns, side="right") - 1
    idx[launch_ns < 0] = -1
    while True:
        out_of = (idx >= 0) & (t1[np.maximum(idx, 0)] < launch_ns)
        if not out_of.any():
            break
        idx[out_of] = enclosing[idx[out_of]]
    return sel, idx


def _sums(sel, idx, device_ns, names) -> dict:
    out = {n: 0 for n in names}
    hit = idx >= 0
    sums = np.bincount(idx[hit], weights=device_ns[hit], minlength=len(sel))
    for s, v in zip(sel, sums):
        out[s.name] += int(v)
    return out


def by_span(launch_ns, device_ns, spans, names, to_ns=None) -> dict:
    """Device ns summed by the name of the innermost span among ``names``
    whose host interval holds each kernel's launch (kernels launched in
    none of them, or never seen launched, are left out), or None where
    spans of two threads overlap.  ``to_ns`` maps span times onto the
    launches' clock (default ``epoch_ns``)."""
    got = innermost(launch_ns, spans, names, to_ns)
    return None if got is None else _sums(*got, device_ns, names)


def layer_ns(ctx):
    """The window's device ns by layer kind and, under ``"engine_tick"``,
    of every kernel launched inside an engine tick, or None without a
    device trace; read once a run (and reported on standard error with
    the clocks' agreement)."""
    if ctx.trace is None:
        return None
    if not hasattr(ctx, "_layer_ns"):
        ctx._layer_ns = _read(ctx)
    return ctx._layer_ns


def _read(ctx):
    from repro_torch.obs import trace as T
    tr = ctx.trace
    at, dev, name = kernels(tr.prof.profiler.kineto_results.events(),
                            tr.win0, tr.win1, names=True)
    kinds = innermost(at, ctx.spans, LAYER_KINDS)
    ticks = innermost(at, ctx.spans, ("engine_tick",))
    m0, w0 = T.IMPORT_ANCHOR
    m1, w1 = T.clock_anchor()
    n_q = max(len(ctx.win["queries"]), 1)
    lines = [f"attribution: {len(dev)} device kernels, "
             f"{int(np.sum(at < 0))} without a recorded launch; spans a "
             f"query: " + ", ".join(
                 f"{sum(s.kind == k for s in ctx.spans) / n_q:.1f} {k}"
                 for k in T.PORT_ONLY_KINDS),
             f"clock drift {((w1 - w0) - (m1 - m0)) / 1e3:.3f} us over "
             f"{(m1 - m0) / 1e9:.1f} s; epoch_ns(window start) - the "
             f"window range's start {(T.epoch_ns(tr.host_t0) - tr.win0) / 1e3:.3f} us"]
    if kinds is None or ticks is None:
        lines.append("spans of two threads overlap: nothing attributed")
        print("\n".join(lines), file=sys.stderr)
        return None
    by_kind = _sums(*kinds, dev, LAYER_KINDS)
    tick = _sums(*ticks, dev, ("engine_tick",))["engine_tick"]
    total = sum(by_kind.values())
    lines.append(f"layer kinds {total / 1e6:.3f} ms of {tick / 1e6:.3f} ms "
                 f"launched in engine ticks ({100.0 * total / max(tick, 1):.2f}%): "
                 + ", ".join(f"{k} {v / 1e6:.3f}" for k, v in by_kind.items()))
    # the ticks' kernels launched outside every layer span, by name
    rest = (ticks[1] >= 0) & (kinds[1] < 0)
    top: dict = {}
    for n, d in zip(name[rest], dev[rest]):
        top[n] = top.get(n, 0) + int(d)
    lines += [f"  outside the kinds: {v / 1e6:.3f} ms {n[:90]}"
              for n, v in sorted(top.items(), key=lambda kv: -kv[1])[:10]]
    print("\n".join(lines), file=sys.stderr)
    return dict(by_kind, engine_tick=tick)


def kind_ms(ctx, kind: str):
    """Device ms a query of kernels launched inside ``kind`` spans, or
    None where the window opened none."""
    if not ctx.win["queries"] or not any(s.name == kind for s in ctx.spans):
        return None
    by = layer_ns(ctx)
    if by is None:
        return None
    return by[kind] / 1e6 / len(ctx.win["queries"])


def span_ms(ctx, names) -> float:
    """Host ms a query of the spans named ``names``, or None where the
    window opened none."""
    sel = [s for s in ctx.spans if s.name in names and s.t1 is not None]
    if not sel or not ctx.win["queries"]:
        return None
    return 1000.0 * sum(s.t1 - s.t0 for s in sel) / len(ctx.win["queries"])
