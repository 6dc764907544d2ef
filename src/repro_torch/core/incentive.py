"""Incentive mechanism: *profit sharing by contribution* (paper §IV.A).

Permission fees fund the treasury (handled by NodeManager.join); after each
round's aggregation the managers distribute rewards proportional to the
committee scores of accepted updates.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core.node import NodeManager


def distribute_rewards(
    manager: NodeManager,
    accepted_scores: Dict[int, float],
    pool: float,
) -> Dict[int, float]:
    """Splits `pool` tokens over uploaders proportionally to score.

    Returns the paid amounts.  Frequent, high-quality contributors earn more
    (the paper's virtuous circle)."""
    if not accepted_scores or pool <= 0:
        return {}
    total = sum(max(s, 0.0) for s in accepted_scores.values())
    paid = {}
    for node_id, score in accepted_scores.items():
        share = pool / len(accepted_scores) if total == 0 else pool * max(score, 0.0) / total
        node = manager.nodes.get(node_id)
        if node is not None:
            node.tokens += share
            paid[node_id] = share
    manager.treasury -= sum(paid.values())
    return paid
