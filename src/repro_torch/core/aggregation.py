"""Update aggregation strategies.

Port of ``repro/core/aggregation.py``:

* ``fedavg``       — BFLC's aggregation over committee-validated updates
  (weighted by scores) and the Basic-FL baseline;
* ``cwmed``        — coordinate-wise median (Yin et al. 2018);
* ``trimmed_mean`` — coordinate-wise trimmed mean.

All operate on flattened (K, D) update stacks; ``aggregate_pytrees`` adapts
trees.  The f32 reductions are plain PyTorch unless ``use_kernels``,
which sends them to the f32 kernels (``repro_torch.kernels.ops``); the
plain median and trimmed mean are those kernels' plain versions
(``repro_torch.kernels.cwmed``), so each reduction has one definition;
``aggregate_quantized_blobs`` feeds chain-format int8 blobs to the fused
kernel, so no f32 stack is materialized.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import to_device
from repro_torch.tree import ravel_pytree, tree_leaves, tree_map


def flatten_updates(updates: Sequence) -> Tuple[torch.Tensor, Callable]:
    """Update trees -> (stacked (K, D) f32 matrix, unravel fn); each row is
    the tree's leaves in sorted-key order, as ``ravel_pytree`` walks it."""
    if not updates:
        raise ValueError("no updates to flatten")
    _, unravel = ravel_pytree(updates[0])
    stack = torch.stack([
        torch.cat([l.reshape(-1).to(torch.float32) for l in tree_leaves(u)])
        for u in updates
    ])
    return stack, unravel


def normalize_weights(K: int, weights: Optional[Any], device="cpu") -> torch.Tensor:
    """(K,) unnormalized (or None -> uniform) -> (K,) f32 summing to 1.

    The one definition both aggregation paths share, so the f32 path and
    the fused int8 kernel weigh committee scores identically."""
    if weights is None:
        w = torch.ones((K,), dtype=torch.float32, device=device)
    elif isinstance(weights, torch.Tensor):
        w = weights.to(device=device, dtype=torch.float32)
    else:
        # host scores (a list, say): a non-blocking copy, so a stage that
        # aggregates does not wait for device work queued before it
        w = to_device(np.asarray(weights, dtype=np.float32), device)
    return w / torch.clamp(w.sum(), min=1e-12)


def fedavg(stack: torch.Tensor, weights: Optional[Any] = None,
           use_kernels: bool = False) -> torch.Tensor:
    """stack: (K, D); weights: (K,) unnormalized."""
    w = normalize_weights(stack.shape[0], weights, stack.device)
    if use_kernels:
        from repro_torch.kernels.ops import fedavg_agg

        return fedavg_agg(stack, w)
    return torch.einsum("k,kd->d", w, stack)


def cwmed(stack: torch.Tensor, use_kernels: bool = False) -> torch.Tensor:
    """Coordinate-wise median over K updates (mean of the middle two for
    even K, as ``jnp.median``; ``torch.median`` would take the lower)."""
    if use_kernels:
        from repro_torch.kernels.ops import cwmed as cwmed_kernel

        return cwmed_kernel(stack)
    from repro_torch.kernels.cwmed import cwmed_ref

    return cwmed_ref(stack)


def trimmed_mean(stack: torch.Tensor, trim: int,
                 use_kernels: bool = False) -> torch.Tensor:
    """Drop the `trim` largest and smallest per coordinate, mean the rest."""
    K = stack.shape[0]
    if not 0 <= 2 * trim < K:
        raise ValueError(f"trim={trim} invalid for K={K}")
    if use_kernels:
        from repro_torch.kernels.ops import trimmed_mean as trimmed_mean_kernel

        return trimmed_mean_kernel(stack, trim=trim)
    from repro_torch.kernels.cwmed import trimmed_mean_ref

    return trimmed_mean_ref(stack, trim)


def aggregate_pytrees(
    updates: Sequence,
    method: str = "fedavg",
    weights: Optional[Sequence[float]] = None,
    trim: int = 1,
    use_kernels: bool = False,
):
    stack, unravel = flatten_updates(updates)
    if method == "fedavg":
        agg = fedavg(stack, weights, use_kernels=use_kernels)
    elif method == "cwmed":
        agg = cwmed(stack, use_kernels=use_kernels)
    elif method == "trimmed_mean":
        agg = trimmed_mean(stack, trim, use_kernels=use_kernels)
    else:
        raise ValueError(method)
    return unravel(agg)


def aggregate_quantized_blobs(
    blobs: Sequence[dict],
    unravel,
    method: str = "fedavg",
    weights: Optional[Sequence[float]] = None,
    trim: int = 1,
):
    """Aggregate straight from K chain-format int8 blobs ({"q","scales","d"})
    through the fused kernel: one int8 read, no f32 stack."""
    from repro_torch.kernels.ops import aggregate_quantized

    q = torch.stack([b["q"] for b in blobs])
    scales = torch.stack([b["scales"] for b in blobs])
    flat = aggregate_quantized(q, scales, int(blobs[0]["d"]), method=method,
                               weights=weights, trim=trim)
    return unravel(flat)


def apply_update(params, update, scale: float = 1.0):
    """params + scale * update (tree add)."""
    return tree_map(lambda p, u: p + scale * u.to(p.dtype), params, update)
