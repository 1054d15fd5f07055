"""The theory layer on both packages: formula shapes, empirical soundness
of the vote bound, and equal values.

The cases of tests/test_theory.py, each run on ``repro.core.theory`` and
on ``repro_torch.core.theory`` (the ``theory`` fixture); the last case
holds every formula of the two packages equal on a grid of inputs.
"""
import numpy as np
import pytest

from repro.core import theory as jtheory
from repro_torch.core import theory as ttheory


@pytest.fixture(params=["ref", "port"])
def theory(request):
    return {"ref": jtheory, "port": ttheory}[request.param]


def test_xi_monotone_in_epsilon(theory):
    """Larger tolerance -> smaller required sample ratio (Table 5 trend)."""
    xs = [theory.xi_for_epsilon_univote(e, sigma2=0.01) for e in
          (0.10, 0.15, 0.20, 0.25, 0.30)]
    assert all(a >= b for a, b in zip(xs, xs[1:]))
    assert all(0 < x <= 1 for x in xs)


def test_simvote_xi_at_least_univote(theory):
    """Paper §4.5: SimVote's required xi exceeds UniVote's (looser bound)."""
    for e in (0.1, 0.2, 0.3):
        xu = theory.xi_for_epsilon_univote(e, sigma2=0.006)
        xs = theory.xi_for_epsilon_simvote(e, sigma2=0.006, v=2.0)
        assert xs >= xu


def test_epsilon_for_xi_inverts(theory):
    for eps in (0.1, 0.2, 0.3):
        xi = theory.xi_for_epsilon_univote(eps, sigma2=0.02, l=0.9996)
        back = theory.epsilon_for_xi(xi, n=20000, sigma2=0.02, l=0.9996)
        assert back <= eps * 1.3 + 1e-6  # inverse within slack of forward


def test_bernstein_tail_decreases_with_k(theory):
    tails = [theory.bernstein_tail(k, 10000, 0.1, 0.05) for k in
             (10, 50, 200, 1000)]
    assert all(a >= b for a, b in zip(tails, tails[1:]))


def test_vote_error_bound_form(theory):
    assert theory.vote_error_bound(0.15, 0.85, 0.1) == pytest.approx(0.25)
    assert theory.vote_error_bound(0.15, 0.85, 0.0) == pytest.approx(0.15)


def test_empirical_bound_soundness(theory):
    """Monte-Carlo: when the vote commits, empirical disagreement obeys
    max(lb+eps, 1-(ub-eps)) at the stated confidence (Theorem 3.3)."""
    rng = np.random.default_rng(0)
    lb, ub, eps, l = 0.15, 0.85, 0.1, 0.9996
    sigma2 = 0.25
    xi = theory.xi_for_epsilon_univote(eps, sigma2, l)
    bound = theory.vote_error_bound(lb, ub, eps)
    violations = trials = 0
    for _ in range(300):
        n = 5000
        mu = rng.choice([0.03, 0.5, 0.95])
        x = rng.random(n) < mu
        k = max(10, int(xi * n))
        sample = rng.choice(n, size=k, replace=False)
        score = x[sample].mean()
        if score >= ub:
            err = 1 - x.mean()
        elif score <= lb:
            err = x.mean()
        else:
            continue  # vote did not commit
        trials += 1
        if err > bound:
            violations += 1
    assert trials > 50
    assert violations / trials < 0.05  # failure prob is ~2*l^n << 5%


def test_choose_sample_size(theory):
    assert theory.choose_sample_size(10000, 0.005, 101) == 101
    assert theory.choose_sample_size(100000, 0.005, 101) == 500
    assert theory.choose_sample_size(50, 0.005, 101) == 50


def test_formulas_equal_across_packages():
    for eps in (0.05, 0.1, 0.2, 0.3):
        for s2 in (0.006, 0.02, 0.25):
            for f, args in (
                    ("xi_for_epsilon_univote", (eps, s2)),
                    ("xi_for_epsilon_simvote", (eps, s2, 0.9996, 2.0)),
                    ("bernstein_tail", (int(eps * 1000), 10000, s2, eps)),
                    ("epsilon_for_xi", (eps / 10, 20000, s2)),
                    ("vote_error_bound", (0.15, 0.85, eps))):
                assert getattr(ttheory, f)(*args) == \
                    getattr(jtheory, f)(*args), (f, args)
    for m in (1, 50, 10_000, 100_000):
        assert ttheory.choose_sample_size(m, 0.005, 101) == \
            jtheory.choose_sample_size(m, 0.005, 101)
