"""Nothing the harness loads is JAX or the JAX package (top-level names
compared whole: the port's ``repro_torch`` starts with ``repro``), and
the reference side, the architecture modules under ``archs/`` with it,
loads nothing of the program."""
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

HARNESS = """
import sys, glob, os
sys.path[:0] = [{bench!r}, os.path.join({bench!r}, "..", "src")]
import run, control
from benchkit import cell, csv_ref, data, devtrace, flops, oracle, reference, spec, text
for path in sorted(glob.glob(os.path.join({bench!r}, "metrics", "*.py"))):
    cell.load_reader(os.path.basename(path)[:-3])
for path in sorted(glob.glob(os.path.join({bench!r}, "archs", "[!_]*.py"))):
    spec.arch({{"arch": os.path.basename(path)[:-3]}})
import repro_torch.api, repro_torch.serving, repro_torch.models.lm
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import sys, os, glob
sys.path[:0] = [{bench!r}]
from benchkit import csv_ref, data, flops, reference, spec, text
for path in sorted(glob.glob(os.path.join({bench!r}, "archs", "[!_]*.py"))):
    spec.arch({{"arch": os.path.basename(path)[:-3]}})
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code.format(bench=HERE)],
                         capture_output=True, text=True, check=True,
                         env={**os.environ, "PYTHONPATH": ""})
    return set(out.stdout.split())


def test_harness_loads_no_jax():
    names = _top_level(HARNESS)
    assert "repro_torch" in names
    assert not names & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    names = _top_level(REFERENCE)
    assert not names & (FORBIDDEN | {"repro_torch"})
