"""PBFT message accounting for the committee's block agreement.

The paper runs FISCO-BCOS with PBFT underneath the CCM.  The CCM reduces
*validation* cost to P·Q; the committee must still agree on each packed
block.  PBFT among Q committee members costs per consensus instance:

    pre-prepare: (Q-1)   prepare: Q(Q-1)   commit: Q(Q-1)
    total ≈ 2Q² - Q - 1 messages

BFLC runs one instance per packed block (k update blocks + 1 model block
per round), among Q members only.  Network-wide PBFT (the naive
decentralization the paper argues against) would run it among all A active
nodes.  `round_messages` exposes both so benchmarks/consensus_cost.py can
plot the full communication picture, not just validation counts.

Safety bound: PBFT tolerates f = floor((Q-1)/3) Byzantine members — the
committee additionally requires an honest majority (> Q/2) for median
scoring, so the binding constraint is the CCM's, matching §IV.C.

A pure-Python copy of ``repro/core/pbft.py``.
"""
from __future__ import annotations

from dataclasses import dataclass


def pbft_instance_messages(n: int) -> int:
    """Messages for one PBFT consensus among n replicas."""
    if n <= 1:
        return 0
    return (n - 1) + 2 * n * (n - 1)


def pbft_fault_tolerance(n: int) -> int:
    return max(0, (n - 1) // 3)


@dataclass
class RoundMessages:
    validation: int          # CCM: P updates x Q validators
    committee_pbft: int      # (k+1) blocks agreed among Q
    total_ccm: int
    network_pbft: int        # naive: (k+1) blocks agreed among all active


def round_messages(P: int, Q: int, k: int) -> RoundMessages:
    """Full per-round communication: CCM validation + committee PBFT vs
    network-wide PBFT."""
    validation = P * Q
    committee = (k + 1) * pbft_instance_messages(Q)
    network = (k + 1) * pbft_instance_messages(P + Q)
    return RoundMessages(
        validation=validation,
        committee_pbft=committee,
        total_ccm=validation + committee,
        network_pbft=network,
    )
