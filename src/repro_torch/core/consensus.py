"""Committee Consensus Mechanism — CCM (paper §III.B).

The committee validates each incoming local update *before* it is appended
to the chain (communication-based consensus).  Validation is the paper's
minimized approach: each member scores the update by the validation accuracy
on its own local data; the member scores are combined by **median** (robust
to a minority of colluding members).  Qualified updates (score above a
threshold policy) are packed as update blocks; when k accumulate, the
committee aggregates them into the next model block.

Message-cost accounting (paper §V.A): validating P trainer updates with a
committee of Q costs P*Q validations/messages, vs (P+Q)^2 for broadcast
consensus among all active nodes — `consensus_cost` exposes both for the
benchmarks.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class ValidationRecord:
    uploader: int
    member_scores: Dict[int, float]       # committee member -> score
    median_score: float
    accepted: bool


@dataclass
class ConsensusStats:
    validations: int = 0                  # P*Q counter
    accepted: int = 0
    rejected: int = 0

    def broadcast_equivalent(self, active_nodes: int) -> int:
        return active_nodes * active_nodes


class CommitteeConsensus:
    """One round's committee: scores updates, decides acceptance."""

    def __init__(
        self,
        member_ids: Sequence[int],
        score_fn: Optional[Callable[[int, object], float]] = None,
        accept_threshold: float = 0.0,
        threshold_mode: str = "relative",   # "relative" | "absolute"
    ):
        """score_fn(member_id, update_payload) -> validation accuracy in [0,1].

        May be omitted when member scores are computed in one batched
        call *after* construction — bind them via ``bind_score_table``
        before the first ``validate``; an unbound consensus refuses to
        validate rather than silently scoring nothing.

        threshold_mode "relative": accept if median score >= accept_threshold
        * (running mean of accepted scores); "absolute": fixed cutoff.
        """
        self.member_ids = list(member_ids)
        self.score_fn = score_fn
        self.accept_threshold = accept_threshold
        self.threshold_mode = threshold_mode
        self.stats = ConsensusStats()
        self.records: List[ValidationRecord] = []
        self._accepted_scores: List[float] = []

    def bind_score_table(
        self, table: Dict[int, Dict[int, float]]
    ) -> None:
        """Score from a precomputed ``{uploader: {member: score}}`` matrix
        (e.g. the runtime's one-call vmapped P x Q accuracy matrix).

        Holds a *reference*: rows added to ``table`` after binding are
        visible, so a multi-cohort round binds once and keeps filling the
        table.  With a table bound, ``validate``'s ``update`` argument is
        the uploader id (the row key)."""
        self.score_fn = lambda member, uploader: table[uploader][member]

    def validate(self, uploader: int, update) -> ValidationRecord:
        if self.score_fn is None:
            raise ValueError(
                "CommitteeConsensus has no score_fn bound — pass score_fn "
                "at construction or call bind_score_table() first"
            )
        member_scores = {
            m: float(self.score_fn(m, update)) for m in self.member_ids
        }
        self.stats.validations += len(self.member_ids)
        median = float(np.median(list(member_scores.values())))
        accepted = self._accept(median)
        rec = ValidationRecord(uploader, member_scores, median, accepted)
        self.records.append(rec)
        if accepted:
            self.stats.accepted += 1
            self._accepted_scores.append(median)
        else:
            self.stats.rejected += 1
        return rec

    def _accept(self, median: float) -> bool:
        if self.threshold_mode == "absolute":
            return median >= self.accept_threshold
        if not self._accepted_scores:
            return True
        baseline = float(np.mean(self._accepted_scores))
        return median >= self.accept_threshold * baseline

    def accepted_records(self) -> List[ValidationRecord]:
        return [r for r in self.records if r.accepted]

    def candidate_scores(self) -> Dict[int, float]:
        """Validated-update providers -> score (election input, §IV.B)."""
        return {r.uploader: r.median_score for r in self.accepted_records()}


def consensus_cost(num_trainers: int, committee_size: int) -> Tuple[int, int]:
    """Returns (ccm_cost, broadcast_cost) = (P*Q, (P+Q)^2)  — paper §V.A."""
    P, Q = num_trainers, committee_size
    return P * Q, (P + Q) ** 2


def consensus_cost_tiered(num_trainers: int, tiers: int,
                          sub_committee_size: int,
                          committee_size: int) -> int:
    """Validation-message cost of a two-tier round (§V's network sharding).

    Each of the P trainers is validated by its slice's sub-committee of q
    members (P*q total across the S slices), then the S sub-aggregates are
    validated by the tier-2 committee of Q members — so the flat P*Q term
    drops to P*q + S*Q, with q fixed by the slice size rather than growing
    with the community."""
    return num_trainers * sub_committee_size + tiers * committee_size
