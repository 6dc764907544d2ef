"""Committee election strategies (paper §IV.B).

A new committee is elected at the end of each round *from the providers of
validated updates* — committee members sit out training, so election also
rotates the validation set (the k-fold property of §III.B).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

RANDOM = "random"
BY_SCORE = "by_score"
MULTI_FACTOR = "multi_factor"


def elect(
    method: str,
    rng: np.random.Generator,
    candidate_scores: Dict[int, float],
    committee_size: int,
    factors: Dict[int, float] | None = None,
    score_weight: float = 0.7,
) -> List[int]:
    """Returns the node ids of the next committee.

    candidate_scores: validated-update providers of this round -> median
    committee score of their update.
    factors: optional per-node secondary factor (e.g. network transmission
    rate) for MULTI_FACTOR.
    """
    if not candidate_scores:
        return []
    ids = np.array(sorted(candidate_scores))
    m = min(committee_size, len(ids))
    if method == RANDOM:
        # improves generalization; weaker against disguised malicious nodes
        return sorted(rng.choice(ids, size=m, replace=False).tolist())
    if method == BY_SCORE:
        # top validation scores: raises the cost of attack (paper's default)
        scores = np.array([candidate_scores[i] for i in ids])
        order = np.argsort(-scores, kind="stable")
        return sorted(ids[order[:m]].tolist())
    if method == MULTI_FACTOR:
        scores = np.array([candidate_scores[i] for i in ids], dtype=float)
        f = np.array([(factors or {}).get(i, 0.0) for i in ids], dtype=float)

        def norm(v):
            lo, hi = v.min(), v.max()
            return np.zeros_like(v) if hi == lo else (v - lo) / (hi - lo)

        combined = score_weight * norm(scores) + (1 - score_weight) * norm(f)
        order = np.argsort(-combined, kind="stable")
        return sorted(ids[order[:m]].tolist())
    raise ValueError(f"unknown election method {method!r}")
