"""Generic federated partitioners (for datasets that arrive centralized).

A numpy-only copy of ``repro/data/partition.py``: the same labels and seed
give the same per-client index arrays in both packages.
"""
from __future__ import annotations

from typing import List

import numpy as np


def dirichlet_partition(
    labels: np.ndarray, num_clients: int, alpha: float, seed: int = 0,
    min_size: int = 2,
) -> List[np.ndarray]:
    """Non-IID Dirichlet split: returns per-client index arrays."""
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    while True:
        buckets: List[List[int]] = [[] for _ in range(num_clients)]
        for c in classes:
            idx = np.where(labels == c)[0]
            rng.shuffle(idx)
            props = rng.dirichlet(np.full(num_clients, alpha))
            cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
            for b, part in zip(buckets, np.split(idx, cuts)):
                b.extend(part.tolist())
        if min(len(b) for b in buckets) >= min_size:
            break
    return [np.array(sorted(b)) for b in buckets]


def leaf_style_partition(
    labels: np.ndarray, num_clients: int, classes_per_client: int,
    seed: int = 0,
) -> List[np.ndarray]:
    """LEAF-style: each client sees only a few classes."""
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    per_class = {c: list(np.where(labels == c)[0]) for c in classes}
    for c in classes:
        rng.shuffle(per_class[c])
    out = []
    for _ in range(num_clients):
        chosen = rng.choice(classes, classes_per_client, replace=False)
        take = []
        for c in chosen:
            k = max(1, len(per_class[c]) // num_clients * 2)
            take.extend(per_class[c][:k])
            per_class[c] = per_class[c][k:] + per_class[c][:k]
        out.append(np.array(sorted(take)))
    return out
