"""The port's examples run on the CPU with their inline contract asserts.

Each ``repro_torch.examples`` module runs on the card by default; here
``main(device="cpu")`` runs it through the kernels' plain versions.  The
stream demo's asserts are the stream contracts (sublinear per-tick cost,
exact delivery across a kill and restart, a zero-call restore), the
service demo's the service's (serial bit-identity, merged batches, a
zero-call reload), the distributed demo's the sharded and logged runs'.
"""
import importlib

import pytest
import torch

EXAMPLES = ["quickstart", "watch_demo", "serve_filter", "service_demo",
            "distributed_demo", "incremental_updates"]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu(name, capsys):
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    mod.main(device="cpu")
    out = capsys.readouterr().out
    assert out.startswith("== ")
    if name in ("watch_demo", "service_demo", "distributed_demo"):
        assert out.rstrip().endswith("demo OK")


def test_quickstart_saves_calls_and_routes_the_baseline(capsys):
    from repro_torch.examples import quickstart
    r = quickstart.main(device="cpu")
    out = capsys.readouterr().out
    assert "reference: 4000 LLM calls (linear scan)" in out
    assert r.order == ["mentions_acting", "positive"]


def test_watch_demo_tail_pays_what_the_control_pays(capsys):
    from repro_torch.examples import watch_demo
    ticks_c, ticks_b = watch_demo.main(device="cpu")
    assert ticks_b == ticks_c[watch_demo.KILL_AFTER:]
    assert sum(t["rows"] for t in ticks_c) == watch_demo.N


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_refuses_cuda_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main()
