"""The benchmark's CPU tests: the harness and the program at smoke sizes
(widths cut to 64, 3,000 rows), float32, on the CPU."""
import copy
import os
import sys

import pytest

_HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (os.path.join(_HERE, "..", "src"), _HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

SMOKE_LIMITS = {"assign_diff": 0, "ids_diff": 0, "rows_diff": 0,
                "label_diff": 0, "engine_diff": 0, "logit_err": 1e-3}


def smoke_spec(workload: str = "jamba.tc", rows: int = 3000,
               dim: int = 64, own_limits: bool = False) -> dict:
    """A cell of BENCHMARK.json with its configuration cut to smoke size
    by its architecture module's ``smoke``, its table to ``rows`` x
    ``dim``, samples of 24 rows, float32, and limits for a float32
    program (or, with ``own_limits``, the cell's own)."""
    from benchkit import spec
    cs = copy.deepcopy(spec.cell(workload))
    conf = cs["config"]
    arch = spec.arch(conf)
    arch.smoke(conf)
    conf["serving"]["dtype"] = "float32"
    mix = cs["mix"]
    mix["table"].update(rows=rows, dim=dim)
    mix["policy"]["min_sample"] = 24  # fewer prompts a query on the CPU
    mix["check"] = {"queries": 2, "prompts": 48, "block": 48}
    if not own_limits:
        cs["limits"] = {"compare": dict(SMOKE_LIMITS)}
        if arch.dims(conf)["E"] > 1:
            cs["limits"]["compare"]["route_diff"] = 0
            cs["limits"]["router_margin"] = 1e-3
    return cs


@pytest.fixture
def smoke():
    return smoke_spec
