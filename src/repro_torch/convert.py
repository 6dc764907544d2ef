"""Parameter trees across the two packages, through numpy.

The reference's params become numpy with ``jax.tree.map(np.asarray, p)``;
``from_numpy_tree`` turns that nested dict into the port's dict of tensors
with the same keys, shapes and layouts (HWIO conv kernels, (in, out) dense
weights; an LM's ``units`` and ``tail`` stay tuples and its unit leaves
keep their leading ``num_units`` axis, so ``tree_paths`` walks the
reference's key paths in order), and ``to_numpy_tree`` is its inverse.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_map


def from_numpy_tree(tree: Any, device="cpu") -> Any:
    return tree_map(
        lambda a: torch.tensor(np.asarray(a), device=device), tree
    )


def to_numpy_tree(tree: Any) -> Any:
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
