"""Virtual client views: large communities without one shard per client.

A numpy-only copy of ``repro/data/virtual.py``.
``VirtualFederatedDataset`` presents ``num_clients`` virtual clients over a
small base ``FederatedDataset`` by mapping virtual client ``i`` to base
shard ``i % base.num_clients``.  The shard arrays are *aliased*, never
copied, so a large community costs the host memory of its base: what a
tiered round's memory and committee work depend on is how many clients
train, not how distinct their bytes are.

The view reads like ``FederatedDataset`` wherever the round looks:
``client_images[i]`` / ``client_labels[i]``, ``num_clients``,
``client_sizes()`` and the central test set.  ``merged_train`` delegates to
the base (concatenating aliased copies would defeat the aliasing).
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.data.synthetic import FederatedDataset


class _CyclicView:
    """Read-only list view of length ``n`` over ``base`` shards, cyclically."""

    def __init__(self, base: List[np.ndarray], n: int):
        self._base = base
        self._n = int(n)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int) -> np.ndarray:
        i = int(i)
        if i < 0:
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError(f"virtual client {i} out of range [0, {self._n})")
        return self._base[i % len(self._base)]

    def __iter__(self):
        for i in range(self._n):
            yield self[i]


class VirtualFederatedDataset(FederatedDataset):
    """``num_clients`` virtual clients cyclically aliasing a base dataset."""

    def __init__(self, base: FederatedDataset, num_clients: int):
        if num_clients < 1:
            raise ValueError(f"num_clients must be >= 1, got {num_clients}")
        if base.num_clients < 1:
            raise ValueError("base dataset has no clients")
        super().__init__(
            client_images=_CyclicView(base.client_images, num_clients),
            client_labels=_CyclicView(base.client_labels, num_clients),
            test_images=base.test_images,
            test_labels=base.test_labels,
        )
        self.base = base

    def merged_train(self):
        return self.base.merged_train()
