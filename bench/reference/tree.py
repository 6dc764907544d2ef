"""Parameter trees as the chain lays them out: nested dicts walked in sorted
key order, tuples and lists by index.  The chain's flat update vector, its
int8 tiles and its payload digests all follow this order."""
from __future__ import annotations

from typing import Any, List, Tuple

import torch


def paths(tree: Any, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, sub in enumerate(tree) for pl in paths(sub, prefix + (i,))]
    return [(prefix, tree)]


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` leafwise, visiting leaves in ``paths`` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def layout(tree: Any) -> List[Tuple[Tuple, Tuple[int, ...], int, int]]:
    """[(path, shape, lo, hi)] of each leaf's lanes in the flat vector."""
    out, lo = [], 0
    for path, leaf in paths(tree):
        n = leaf.numel()
        out.append((path, tuple(leaf.shape), lo, lo + n))
        lo += n
    return out


def flatten(tree: Any) -> torch.Tensor:
    return torch.cat([leaf.reshape(-1).to(torch.float32)
                      for _, leaf in paths(tree)])


def unflatten(flat: torch.Tensor, like: Any) -> Any:
    """``flat`` cut into ``like``'s leaves (views)."""
    leaves = iter(paths(like))
    parts = {}
    lo = 0
    for path, leaf in leaves:
        n = leaf.numel()
        parts[path] = flat[lo:lo + n].reshape(leaf.shape)
        lo += n

    def build(sub, prefix=()):
        if isinstance(sub, dict):
            return {k: build(sub[k], prefix + (k,)) for k in sub}
        if isinstance(sub, (list, tuple)):
            return type(sub)(build(s, prefix + (i,)) for i, s in enumerate(sub))
        return parts[prefix]

    return build(like)
