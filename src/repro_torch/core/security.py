"""Security analysis of the committee mechanism (paper §IV.C, Fig. 3).

The conspiracy attack: A participating nodes, fraction q malicious, committee
fraction p.  The committee (A*p seats, performance assumed similar) is a
uniform draw without replacement, so the number of malicious seats X follows
Hypergeometric(A, A*q, A*p).  The attack succeeds iff X > A*p/2.

``attack_success_probability`` computes P[X > A*p/2] exactly in log space.
A numpy-only copy of ``repro/core/security.py``.
"""
from __future__ import annotations

import numpy as np
from math import lgamma


def _log_comb(n: int, k: int) -> float:
    if k < 0 or k > n:
        return -np.inf
    return lgamma(n + 1) - lgamma(k + 1) - lgamma(n - k + 1)


def hypergeom_pmf_log(A: int, K: int, n: int, x: int) -> float:
    """log P[X = x], X ~ Hypergeom(population A, successes K, draws n)."""
    return _log_comb(K, x) + _log_comb(A - K, n - x) - _log_comb(A, n)


def attack_success_probability(A: int, p: float, q: float) -> float:
    """P[malicious seats > half the committee] (Fig. 3)."""
    n = int(round(A * p))          # committee seats
    K = int(round(A * q))          # malicious nodes
    if n == 0:
        return 0.0
    threshold = n / 2.0
    xs = np.arange(int(np.floor(threshold)) + 1, n + 1)
    if len(xs) == 0:
        return 0.0
    logs = np.array([hypergeom_pmf_log(A, K, n, int(x)) for x in xs])
    # drop the x == threshold boundary when n even ("more than half")
    if n % 2 == 0 and xs[0] == threshold:
        logs = logs[1:]
    if len(logs) == 0:
        return 0.0
    m = logs.max()
    if m == -np.inf:
        return 0.0
    return float(np.exp(m) * np.exp(logs - m).sum())


def fig3_grid(A: int = 1000, ps=None, qs=None) -> dict:
    """The Fig. 3 surface: attack probability over (p, q)."""
    ps = ps if ps is not None else np.linspace(0.02, 0.5, 25)
    qs = qs if qs is not None else np.linspace(0.02, 0.98, 49)
    grid = np.zeros((len(ps), len(qs)))
    for i, p in enumerate(ps):
        for j, q in enumerate(qs):
            grid[i, j] = attack_success_probability(A, float(p), float(q))
    return {"A": A, "p": np.asarray(ps), "q": np.asarray(qs), "prob": grid}


def first_committee_honest_majority_invariant(q: float, p: float, A: int) -> float:
    """§IV.C induction argument: if the first committee has an honest
    majority, no malicious update is ever accepted (accepting needs > M/2
    colluding members, who could only have been seated by a previous
    malicious majority).  Returns the probability that a uniformly drawn
    first committee already has a malicious majority — the induction's only
    entry point."""
    return attack_success_probability(A, p, q)
