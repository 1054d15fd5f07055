#!/usr/bin/env python3
"""Time one span of the port's tracer on this host's CPU.

    python3 scripts/time_spans.py [N]

Opens and closes N spans (default 200,000) of kind "step" with two
attributes, inside one open parent span as the CSV driver's leaves are,
in five repeats, and prints the host time a span (the least and the
median over the repeats):

- off: the ambient ``NULL_TRACER`` (tracing off: one no-op call);
- on: a collecting ``Tracer``, fresh each repeat, so its span list grows
  as a traced window's does.

Multiplied by the spans a query (``bench/benchkit/attribution.py``
prints them), this is what the spans cost a query with tracing on and
off.  Needs no card.
"""
import statistics
import sys
import time

from repro_torch.obs.trace import NULL_TRACER, Tracer

N = int(sys.argv[1]) if len(sys.argv) > 1 else 200_000


def per_span(tr) -> float:
    """ns a span: N leaves with two attributes under one parent."""
    with tr.span("vote", kind="vote"):
        t0 = time.perf_counter_ns()
        for i in range(N):
            with tr.span("to_device", kind="step", rows=i, bytes=4 * i):
                pass
        return (time.perf_counter_ns() - t0) / N


for name, make in (("off", lambda: NULL_TRACER), ("on", Tracer)):
    per_span(make())  # warm
    ns = [per_span(make()) for _ in range(5)]
    print(f"{name}: {min(ns):.1f} ns a span (least of 5), "
          f"{statistics.median(ns):.1f} (median), N {N}")
