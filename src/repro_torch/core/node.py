"""Node management (paper §IV.A): alliance-chain permissioning in blacklist
mode, managed by the community's initial nodes (the managers)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

import numpy as np


@dataclass
class Node:
    node_id: int
    data_indices: np.ndarray          # indices into the federated dataset
    is_malicious: bool = False        # ground-truth flag for simulation only
    tokens: float = 0.0               # incentive balance
    score_history: List[float] = field(default_factory=list)

    @property
    def latest_score(self) -> float:
        return self.score_history[-1] if self.score_history else 0.0


class NodeManager:
    """Blacklist-mode admission control + membership registry."""

    def __init__(self, permission_fee: float = 1.0):
        self.nodes: Dict[int, Node] = {}
        self.blacklist: Set[int] = set()
        self.permission_fee = permission_fee
        self.treasury = 0.0

    def join(self, node: Node) -> bool:
        """§IV.A: verification is blacklist-mode — rejected iff kicked before.
        Joining pays the permission fee into the managers' treasury."""
        if node.node_id in self.blacklist:
            return False
        node.tokens -= self.permission_fee
        self.treasury += self.permission_fee
        self.nodes[node.node_id] = node
        return True

    def leave(self, node_id: int) -> None:
        self.nodes.pop(node_id, None)

    def kick(self, node_id: int, reason: str = "misconduct") -> None:
        """Misconduct (misleading updates, model leaking) -> blacklist."""
        self.blacklist.add(node_id)
        self.nodes.pop(node_id, None)

    def active_ids(self) -> List[int]:
        return sorted(self.nodes)

    def sample_active(
        self, rng: np.random.Generator, proportion: float
    ) -> List[int]:
        """The paper's k%-active-nodes sampling: partial offline nodes never
        impede progress — only sampled nodes participate this round."""
        ids = self.active_ids()
        n = max(2, int(round(len(ids) * proportion)))
        return sorted(rng.choice(ids, size=min(n, len(ids)), replace=False).tolist())
