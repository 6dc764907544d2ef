from repro_torch.core.blockchain import Block, Chain, LayoutError, pytree_digest
from repro_torch.core.consensus import CommitteeConsensus, consensus_cost
from repro_torch.core.election import BY_SCORE, MULTI_FACTOR, RANDOM, elect
from repro_torch.core.node import Node, NodeManager
from repro_torch.core.security import attack_success_probability, fig3_grid

__all__ = [
    "Chain",
    "Block",
    "LayoutError",
    "pytree_digest",
    "CommitteeConsensus",
    "consensus_cost",
    "elect",
    "RANDOM",
    "BY_SCORE",
    "MULTI_FACTOR",
    "Node",
    "NodeManager",
    "attack_success_probability",
    "fig3_grid",
]
