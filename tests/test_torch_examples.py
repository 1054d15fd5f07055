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


def test_train_backbone_tiny_trains_and_resumes(tmp_path, capsys):
    """The seventh example at --size tiny: the loss falls (its inline
    assert), a checkpoint lands every --ckpt-every steps and at the end,
    and a rerun with more steps resumes from the newest."""
    from repro_torch.examples import train_backbone
    argv = ["--size", "tiny", "--ckpt-dir", str(tmp_path), "--ckpt-every",
            "3"]
    train_backbone.main(argv + ["--steps", "8"], device="cpu")
    out = capsys.readouterr().out
    assert out.startswith("model: 0.9M params") and "step    0 loss=" in out
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_00000006", "step_00000008"]
    train_backbone.main(argv + ["--steps", "10"], device="cpu")
    out = capsys.readouterr().out
    assert "restored from checkpoint @ step 8" in out
    assert "step    9 loss=" in out and "step    0 loss=" not in out


def test_train_backbone_refuses_cuda_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.examples import train_backbone
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_backbone.main(["--size", "tiny", "--ckpt-dir", str(tmp_path)])
