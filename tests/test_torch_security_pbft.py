"""The port's copies of the §IV.C / §V analysis modules against the
reference's: ``core/security.py`` (the Fig. 3 hypergeometric attack
probability) and ``core/pbft.py`` (PBFT message accounting).

Both copies are numpy / pure Python, so the same arguments must give the
same floats and counts exactly.  Cases: those of ``tests/test_security.py``
and ``tests/test_pbft_and_sharding.py``, plus seeded grids in place of their
property tests.
"""
import numpy as np
import pytest

from repro.core import pbft as ref_pbft
from repro.core import security as ref_security
from repro_torch.core import attack_success_probability, fig3_grid
from repro_torch.core import pbft, security

# (A, p, q) of tests/test_security.py
SECURITY_CASES = [
    (1000, 0.1, 0.0), (1000, 0.1, 1.0), (4, 0.5, 0.5),
    (1000, 0.02, 0.45), (1000, 0.4, 0.45),
] + [(1000, p, q) for p in (0.05, 0.1, 0.3) for q in (0.3, 0.45, 0.60)]


def _grid(seed, n):
    rng = np.random.default_rng(seed)
    return [(int(A), float(p), float(q)) for A, p, q in zip(
        rng.integers(2, 600, n), rng.uniform(0.0, 0.6, n), rng.uniform(0, 1, n))]


@pytest.mark.parametrize("A,p,q", SECURITY_CASES + _grid(0, 40))
def test_attack_success_probability_equals_reference(A, p, q):
    got = attack_success_probability(A, p, q)
    assert got == ref_security.attack_success_probability(A, p, q)
    assert -1e-12 <= got <= 1 + 1e-9


def test_reference_cases_hold_in_the_port():
    assert attack_success_probability(1000, 0.1, 0.0) == 0.0
    assert attack_success_probability(1000, 0.1, 1.0) == pytest.approx(1.0)
    assert attack_success_probability(4, 0.5, 0.5) == pytest.approx(1 / 6)
    for p in (0.05, 0.1, 0.3):
        assert attack_success_probability(1000, p, 0.3) < 1e-3
        assert attack_success_probability(1000, p, 0.60) > 0.8
    assert (attack_success_probability(1000, 0.4, 0.45)
            < attack_success_probability(1000, 0.02, 0.45))
    assert (security.first_committee_honest_majority_invariant(0.45, 0.1, 500)
            == ref_security.first_committee_honest_majority_invariant(0.45, 0.1, 500))


@pytest.mark.parametrize("kw", [
    dict(A=200, ps=np.array([0.1, 0.2]), qs=np.array([0.2, 0.5, 0.8])),
    dict(A=100),
])
def test_fig3_grid_equals_reference(kw):
    got, want = fig3_grid(**kw), ref_security.fig3_grid(**kw)
    assert got["A"] == want["A"]
    for key in ("p", "q", "prob"):
        np.testing.assert_array_equal(got[key], want[key])
    assert np.all(np.diff(got["prob"], axis=1) >= -1e-9)   # monotone in q


@pytest.mark.parametrize("n", list(range(0, 12)) + [36, 100])
def test_pbft_instance_and_tolerance_equal_reference(n):
    assert pbft.pbft_instance_messages(n) == ref_pbft.pbft_instance_messages(n)
    assert pbft.pbft_fault_tolerance(n) == ref_pbft.pbft_fault_tolerance(n)


def test_pbft_reference_cases_hold_in_the_port():
    assert pbft.pbft_instance_messages(1) == 0
    assert pbft.pbft_instance_messages(4) == 3 + 2 * 4 * 3
    assert [pbft.pbft_fault_tolerance(n) for n in (4, 7, 1)] == [1, 2, 0]


@pytest.mark.parametrize("seed", range(4))
def test_round_messages_equal_reference(seed):
    rng = np.random.default_rng(seed)
    for P_, Q, k in zip(rng.integers(2, 200, 10), rng.integers(2, 60, 10),
                        rng.integers(1, 20, 10)):
        P_, Q, k = int(P_), int(Q), int(k)
        m = pbft.round_messages(P_, Q, k)
        r = ref_pbft.round_messages(P_, Q, k)
        assert (m.validation, m.committee_pbft, m.total_ccm, m.network_pbft) \
            == (r.validation, r.committee_pbft, r.total_ccm, r.network_pbft)
        assert m.total_ccm < m.network_pbft + m.validation
        if P_ >= Q:
            assert m.committee_pbft < m.network_pbft
