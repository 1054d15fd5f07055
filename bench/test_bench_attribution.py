"""``benchkit.attribution`` on synthetic profiler events: each kernel goes
by its correlation id to its launch and from there to the innermost named
span holding it; kernels launched outside every span, or never seen
launched, go to no kind; the kinds add up to what the enclosing spans
launched; spans of two threads that overlap give None."""
import types

import numpy as np
import torch

from benchkit import attribution as A
from benchkit.attribution import by_span, kernels

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Ev:
    """A kineto event's accessors, as ``kineto_results.events()`` gives
    them on torch 2.11 (no ``activity_type``)."""

    def __init__(self, name, dev, t0, dur, corr, annotation=False):
        self._v = (name, dev, t0, dur, corr, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def span(name, t0, t1, thread="main"):
    """A span with times in seconds; ``to_ns`` below maps them to ns."""
    return types.SimpleNamespace(name=name, t0=t0, t1=t1, thread=thread,
                                 attrs={})


def to_ns(t):
    return np.rint(np.asarray(t) * 1e9).astype(np.int64)


def launch(corr, at_ns, dur_ns, t_dev):
    """A host runtime launch and its kernel, ``dur_ns`` long on the
    device at ``t_dev``."""
    return [Ev("cudaLaunchKernel", CPU, at_ns, 5, corr),
            Ev(f"k{corr}", CUDA, t_dev, dur_ns, corr)]


def _window():
    spans = [span("engine_tick", 1.0, 2.0),
             span("attn", 1.1, 1.2), span("moe", 1.3, 1.5),
             span("engine_tick", 3.0, 4.0), span("mamba", 3.1, 3.2)]
    ev = []
    ev += launch(1, 1_150_000_000, 100, 5_000_000_000)   # attn
    ev += launch(2, 1_160_000_000, 200, 5_000_001_000)   # attn
    ev += launch(3, 1_400_000_000, 400, 5_000_002_000)   # moe
    ev += launch(4, 1_600_000_000, 800, 5_000_003_000)   # a tick's remainder
    ev += launch(5, 3_150_000_000, 1600, 5_000_004_000)  # mamba
    ev += launch(6, 2_500_000_000, 3200, 5_000_005_000)  # outside every span
    # a device event with no recorded launch, the CPU op numbering that
    # shares correlation ids with the runtime's, a range's device mirror
    ev.append(Ev("orphan", CUDA, 5_000_006_000, 6400, 99))
    ev.append(Ev("aten::mm", CPU, 1_150_000_000, 10, 6))
    ev.append(Ev("bench.window", CUDA, 4_000_000_000, 10 ** 9, 0,
                 annotation=True))
    return spans, ev


def test_kernels_join_launches_by_correlation():
    spans, ev = _window()
    at, dev = kernels(ev, 4_000_000_000, 6_000_000_000)
    assert list(dev) == [100, 200, 400, 800, 1600, 3200, 6400]
    assert list(at) == [1_150_000_000, 1_160_000_000, 1_400_000_000,
                        1_600_000_000, 3_150_000_000, 2_500_000_000, -1]
    # kernels outside the window are left out
    at, dev = kernels(ev, 5_000_003_500, 6_000_000_000)
    assert list(dev) == [800, 1600, 3200, 6400]


def test_innermost_span_takes_each_launch():
    spans, ev = _window()
    at, dev = kernels(ev, 4_000_000_000, 6_000_000_000)
    kinds = by_span(at, dev, spans, A.LAYER_KINDS, to_ns=to_ns)
    assert kinds == {"attn": 300, "mamba": 1600, "moe": 400, "mlp": 0}
    ticks = by_span(at, dev, spans, ("engine_tick",), to_ns=to_ns)
    assert ticks == {"engine_tick": 3100}
    # the kinds and the ticks' remainder make up what the ticks launched;
    # kernels launched outside them, or never seen launched, go to none
    both = by_span(at, dev, spans, ("engine_tick",) + A.LAYER_KINDS,
                   to_ns=to_ns)
    assert both["engine_tick"] == 800
    assert sum(both.values()) == ticks["engine_tick"]
    assert sum(kinds.values()) + both["engine_tick"] == 3100 < dev.sum()


def test_nested_spans_fall_back_to_the_enclosing_one():
    spans = [span("engine_tick", 1.0, 2.0), span("attn", 1.1, 1.2),
             span("attn", 1.3, 1.4)]
    at = np.array([1_250_000_000, 1_350_000_000, 1_900_000_000, 2_100_000_000])
    dev = np.array([1, 2, 4, 8])
    got = by_span(at, dev, spans, ("engine_tick", "attn"), to_ns=to_ns)
    assert got == {"engine_tick": 5, "attn": 2}


def test_overlapping_threads_give_none():
    spans, ev = _window()
    at, dev = kernels(ev, 4_000_000_000, 6_000_000_000)
    other = spans + [span("attn", 1.15, 1.25, thread="lane")]
    assert by_span(at, dev, other, A.LAYER_KINDS, to_ns=to_ns) is None
    # a second thread's spans that overlap none of the first's are fine
    apart = spans + [span("attn", 2.1, 2.2, thread="lane")]
    assert by_span(at, dev, apart, A.LAYER_KINDS, to_ns=to_ns) is not None


def test_read_reports_kinds_and_the_ticks_remainder_by_name(monkeypatch,
                                                            capsys):
    """One read of a window: the kinds and the ticks' total, and on
    standard error the ticks' kernels outside every layer span by name
    and the port's spans a query."""
    from repro_torch.obs import trace as T
    monkeypatch.setattr(T, "epoch_ns", to_ns)
    spans, ev = _window()
    for s in spans:
        s.kind = "layer" if s.name in A.LAYER_KINDS else "engine_tick"
    res = types.SimpleNamespace(events=lambda: ev)
    trace = types.SimpleNamespace(
        prof=types.SimpleNamespace(
            profiler=types.SimpleNamespace(kineto_results=res)),
        win0=4_000_000_000, win1=6_000_000_000, host_t0=4.0)
    ctx = types.SimpleNamespace(spans=spans, trace=trace,
                                win={"queries": [{}, {}]})
    got = A.layer_ns(ctx)
    assert got == {"attn": 300, "mamba": 1600, "moe": 400, "mlp": 0,
                   "engine_tick": 3100}
    err = capsys.readouterr().err
    assert "0.0 step, 1.5 layer" in err
    assert "outside the kinds: 0.001 ms k4" in err
    assert "k6" not in err and "orphan" not in err
    assert A.kind_ms(ctx, "mamba") == 1600 / 1e6 / 2


def test_readers_find_nothing_in_a_program_without_the_spans():
    """A program without the layer and step spans (the benchmark's readers
    laid over an older one): every new reader returns None, none raises."""
    from benchkit import cell as C
    spans = [span("query", 0.0, 5.0), span("engine_tick", 1.0, 2.0)]
    ctx = types.SimpleNamespace(spans=spans, trace=object(),
                                win={"queries": [{}]})
    for name in ("host_pack_ms", "seed_ms", "lloyd_ms", "h2d_mb", "attn_ms",
                 "mlp_ms", "mamba_ms", "moe_ms"):
        assert C.load_reader(name)(ctx) is None


def test_traced_smoke_run_reports_the_driver_steps(smoke):
    """A traced run on the CPU at smoke size reports the four host-side
    metrics (the device ones need a device trace), within ``driver_ms``.
    The dense cell: the driver's code is the same in every cell, and the
    hybrid's layer spans are held in tests/test_torch_trace_spans.py."""
    import run as R
    out = R.run(smoke("internvl2.tc"), 5, 0.0, True, device="cpu",
                t_start=0.0)
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert out["correct"]
    assert all(m[k] > 0 for k in ("host_pack_ms", "seed_ms", "lloyd_ms",
                                  "h2d_mb"))
    assert m["host_pack_ms"] + m["seed_ms"] + m["lloyd_ms"] <= m["driver_ms"]
    assert not {"attn_ms", "mlp_ms", "mamba_ms", "moe_ms"} & m.keys()
