"""The PyTorch port stands alone: no JAX, no reference package, no silent
CPU path."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.api import Session
from repro_torch.core.csv_filter import semantic_filter
from repro_torch.core.oracle import SyntheticOracle
from repro_torch.data import make_dataset
from repro_torch.configs import smoke_config
from repro_torch.embeddings import EmbeddingModel
from repro_torch.serving import ServingEngine
from repro_torch.service import FilterService, QueryScheduler

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_port_imports_with_jax_blocked():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import repro_torch.core.csv_filter\n"
            "import repro_torch.serving.engine\n"
            "import repro_torch.models.lm\n"
            "import repro_torch.api, repro_torch.plan, repro_torch.core\n"
            "import repro_torch.distributed, repro_torch.embeddings\n"
            "import repro_torch.obs.audit, repro_torch.core.bm25\n"
            "import repro_torch.service, repro_torch.checkpoint\n"
            "import repro_torch.obs.health, repro_torch.obs.status\n"
            "import repro_torch.obs.flight, repro_torch.obs.export\n"
            "import repro_torch.obs, repro_torch.embeddings.encoder\n"
            "import repro_torch.distributed.coordinator\n"
            "import repro_torch.distributed.partition\n"
            "import repro_torch.stream, repro_torch.launch.serve\n"
            "import repro_torch.launch.watch, repro_torch.examples\n"
            "import repro_torch.examples.watch_demo\n"
            "import repro_torch.train, repro_torch.launch.train\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.op_cost\n"
            "import repro_torch.launch.collectives, repro_torch.launch.mesh\n"
            "import repro_torch.examples.train_backbone\n"
            "assert 'jax' not in [m.split('.')[0] for m in sys.modules\n"
            "                     if sys.modules[m] is not None]\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = make_dataset("imdb_review", n=200, dim=8)
    oracle = SyntheticOracle(ds.labels["RV-Q1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        semantic_filter(ds.embeddings, oracle)
    assert oracle.stats.n_calls == 0  # refused before any work
    cfg = smoke_config("llama3.1-8b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, params={})
    res = semantic_filter(ds.embeddings, oracle, device="cpu")
    assert res.mask.shape == (200,)
    # the encoder, the scheduler and the service: on the card unless the
    # caller asks for the CPU (the scheduler and the service run on their
    # session's device)
    enc = smoke_config("e5-large")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EmbeddingModel(enc)
    for entry in (QueryScheduler, FilterService):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry(Session())
    assert EmbeddingModel(enc, device="cpu").encode(["a b"]).shape == (1, 64)
    cpu = Session(device="cpu")
    svc = FilterService(cpu)
    assert svc.scheduler.session.device.type == "cpu"
    svc.close()
    sched = QueryScheduler(Session(device="cpu"))
    sched.close()
