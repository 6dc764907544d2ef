"""Nested-dict parameter trees: the port's stand-in for JAX pytrees.

Leaves are visited in sorted-key order, recursively — the order
``jax.tree.flatten`` and ``ravel_pytree`` walk a dict.  The int8 codec's
2048-lane tiles cross leaf boundaries, so a different leaf order would
change every scale written to the chain.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch


def tree_paths(tree: Any, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """[(key path, leaf)] in sorted-key order; lists and tuples by index."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_paths(tree[k], prefix + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, sub in enumerate(tree):
            out += tree_paths(sub, prefix + (i,))
        return out
    return [(prefix, tree)]


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over trees of the same structure, visiting
    leaves in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)
        )
    return fn(tree, *rest)


def tree_stack(trees: List[Any]) -> Any:
    """[tree] -> tree of leaves stacked on a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def tree_unstack(tree: Any, n: int) -> List[Any]:
    return [tree_map(lambda x: x[i], tree) for i in range(n)]


def ravel_pytree(tree: Any) -> Tuple[torch.Tensor, Callable]:
    """tree -> (flat 1-D tensor in sorted-key leaf order, unravel)."""
    leaves = tree_leaves(tree)
    shapes = [tuple(l.shape) for l in leaves]
    dtypes = [l.dtype for l in leaves]
    sizes = [l.numel() for l in leaves]
    flat = torch.cat([l.reshape(-1).to(torch.float32) for l in leaves])

    def unravel(vec: torch.Tensor) -> Any:
        parts = iter(torch.split(vec, sizes))
        it = iter(zip(shapes, dtypes))

        def rebuild(_leaf):
            shape, dtype = next(it)
            return next(parts).reshape(shape).to(dtype)

        return tree_map(rebuild, tree)

    return flat, unravel
