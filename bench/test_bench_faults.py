"""A whole run of a cell on the CPU at smoke size, past the look for a
card: sound, it is correct; with the timed path broken underneath, once
for each fault the cell can have, it is not; with the reference in lower
precision in the program's place (the control), it is not.  (One chip:
no exchange between chips to leave out.)"""
import numpy as np
import pytest
import torch

import control
import run as R
from benchkit import cell as C
from repro_torch.core import voting
from repro_torch.models import lm
from repro_torch.serving.engine import ServingEngine


def _run(cs, seed=3):
    return R.run(cs, seed, 0.0, False, device="cpu", t_start=0.0)


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(lm, "_apply_layer",
                        lambda cfg, spec, p, h, *a, **k: (h, None))


def _half_batch(monkeypatch):
    real = ServingEngine.first_token_logits

    def half(self, prompts, token_ids=None):
        n = max(1, len(prompts) // 2)
        out = real(self, prompts[:n], token_ids=token_ids[:n])
        return np.concatenate([out, np.repeat(out.mean(0, keepdims=True),
                                              len(prompts) - n, 0)])
    monkeypatch.setattr(ServingEngine, "first_token_logits", half)


def _vote_altered(monkeypatch):
    real = voting._partition_by_score

    def altered(scores, lb, ub):
        vr = real(scores, lb, ub)
        if len(vr.decided_true):
            vr.decided_false = np.append(vr.decided_false, vr.decided_true[0])
            vr.decided_true = vr.decided_true[1:]
        return vr
    monkeypatch.setattr(voting, "_partition_by_score", altered)


def _logit_altered(monkeypatch):
    """The yes logit of the first batch of every engine call, plus 1."""
    real_call = ServingEngine.first_token_logits
    real = lm.first_logits_select
    first = []

    def call(self, prompts, token_ids=None):
        first.append(True)
        return real_call(self, prompts, token_ids=token_ids)

    def altered(*a, **k):
        out = real(*a, **k)
        if first:
            out[:, 0] += 1.0
            first.clear()
        return out
    monkeypatch.setattr(ServingEngine, "first_token_logits", call)
    monkeypatch.setattr(lm, "first_logits_select", altered)


def test_sound_run_is_correct(smoke):
    out = _run(smoke(rows=2000, dim=32))
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _vote_altered, _logit_altered])
def test_fault_is_not_correct(smoke, monkeypatch, fault):
    fault(monkeypatch)
    out = _run(smoke(rows=2000, dim=32))
    assert not out["correct"], out["checks"]


def test_control_is_not_correct(smoke):
    cs = smoke(rows=2000, dim=32)
    cell = C.Cell(cs, "cpu")
    cell.build(4)
    qs = [cell.query(q, cell.labels_of(q)) for q in range(2)]
    win = {"queries": qs, "served": sum(r["calls"] for r in qs),
           "assign": cell.handle.precluster(4, 0)}
    cell.release()
    low = control.control_numbers(cell, qs, win, 4)
    assert not all(ok for *_, ok in C.checks(low, cs["limits"]))
    torch.testing.assert_close(torch.tensor(low["label_diff"]),
                               torch.tensor(0))


_OWN = ["jamba.tc", "internvl2.tc"]


@pytest.mark.parametrize("workload", _OWN)
def test_sound_run_meets_the_cells_own_limits(smoke, workload):
    out = _run(smoke(workload, rows=2000, dim=32, own_limits=True))
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _logit_altered])
@pytest.mark.parametrize("workload", _OWN)
def test_fault_fails_the_cells_own_logit_limit(smoke, monkeypatch, workload,
                                               fault):
    """The configuration's own compared statistic and limit, not the
    smoke limits, catch each fault of the served logits."""
    cs = smoke(workload, rows=2000, dim=32, own_limits=True)
    fault(monkeypatch)
    out = _run(cs)
    c = out["checks"]["logit_err"]
    assert c["value"] > c["limit"], out["checks"]
    assert not out["correct"]
