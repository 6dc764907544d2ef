"""Public wrappers around the kernels: pad once, dispatch, adapt trees.

Port of ``repro/kernels/ops.py`` (everything but the sharded factories).
Callers hand over an f32 vector or (K, D) stack, or the chain's quantized
representation (int8 stack + per-tile scales); padding to the tile
boundary happens exactly once here, and the kernel wrappers below pick
the CUDA kernel or the plain version by the tensor's device.  The f32
aggregation kernels reduce each lane on its own and mask the ragged edge,
so their stacks go in unpadded.

  aggregate(stack, method=..., weights=..., trim=...)   f32 path
  fedavg_agg / cwmed / trimmed_mean                     its three kernels
  quantize(x) / dequantize(q, scales, D)                codec, one vector
  quantize_stack(stack)                                 round codec, K rows
  aggregate_quantized(q, scales, D, method=...)         fused int8 path
  candidates_from_quantized(base, q, scales, D)         int8 scoring path
  Int8UpdateCodec                                       chain payload codec
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.aggregation import normalize_weights
from repro_torch.kernels.cwmed import cwmed_kernel, trimmed_mean_kernel
from repro_torch.kernels.fedavg_agg import fedavg_agg_kernel
from repro_torch.kernels.fused_agg import METHODS, fused_agg_kernel
from repro_torch.kernels.fused_score import fused_candidates_kernel
from repro_torch.kernels.quantize import (
    dequantize_kernel,
    quantize_kernel,
    quantize_stack_kernel,
)
from repro_torch.kernels.tiling import BLOCK_D
from repro_torch.tree import ravel_pytree


def padded_dim(d: int) -> int:
    """Smallest multiple of BLOCK_D >= d."""
    return d + (-d) % BLOCK_D


def _pad_to_block(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Zero-pad the last axis to the tile boundary (contiguous result)."""
    pad = (-x.shape[-1]) % BLOCK_D
    if pad == 0:
        return x.contiguous(), 0
    return F.pad(x, (0, pad)), pad


# ----------------------------------------------------------------------
# method dispatch: f32 stacks
# ----------------------------------------------------------------------
def aggregate(stack: torch.Tensor, method: str = "fedavg",
              weights: Optional[Any] = None, trim: int = 1) -> torch.Tensor:
    """(K, D) f32 -> (D,) through the f32 kernels.

    fedavg weights may be unnormalized (e.g. raw committee scores): they
    are normalized to sum 1 here; ``fedavg_agg`` takes a raw weighted
    sum."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r} (want one of {METHODS})")
    if method == "fedavg":
        return fedavg_agg(stack, normalize_weights(stack.shape[0], weights,
                                                   stack.device))
    stack = stack.to(torch.float32).contiguous()
    if method == "cwmed":
        return cwmed_kernel(stack)
    return trimmed_mean_kernel(stack, trim=trim)


def fedavg_agg(stack: torch.Tensor, weights: Any) -> torch.Tensor:
    """(K, D) x (K,) -> (D,) weighted SUM: the weights are used as given."""
    w = torch.as_tensor(weights, dtype=torch.float32, device=stack.device)
    return fedavg_agg_kernel(stack.to(torch.float32).contiguous(),
                             w.contiguous())


def cwmed(stack: torch.Tensor) -> torch.Tensor:
    """(K, D) -> (D,) coordinate-wise median."""
    return aggregate(stack, "cwmed")


def trimmed_mean(stack: torch.Tensor, trim: int = 1) -> torch.Tensor:
    """(K, D) -> (D,) coordinate-wise trimmed mean."""
    return aggregate(stack, "trimmed_mean", trim=trim)


# ----------------------------------------------------------------------
# quantized representation: codec, fused aggregation, fused candidates
# ----------------------------------------------------------------------
def quantize(x: torch.Tensor):
    """(D,) -> (q int8 (Dpad,), scales (Dpad // BLOCK_D,), D)."""
    D = x.shape[0]
    if D == 0:  # zero-size trees: nothing to tile, nothing to store
        return (torch.zeros((0,), dtype=torch.int8, device=x.device),
                torch.zeros((0,), dtype=torch.float32, device=x.device), 0)
    padded, _ = _pad_to_block(x.to(torch.float32))
    q, s = quantize_kernel(padded)
    return q, s, D


def dequantize(q: torch.Tensor, scales: torch.Tensor, D: int) -> torch.Tensor:
    if D == 0:
        return torch.zeros((0,), dtype=torch.float32, device=q.device)
    return dequantize_kernel(q, scales)[:D]


def quantize_stack(stack: torch.Tensor):
    """(K, D) f32 -> (q (K, Dpad) int8, scales (K, nblk) f32, D).

    One launch quantizes a whole round's K update vectors; padded lanes
    quantize to 0 and are never read back past D."""
    K, D = stack.shape
    if D == 0:
        return (torch.zeros((K, 0), dtype=torch.int8, device=stack.device),
                torch.zeros((K, 0), dtype=torch.float32, device=stack.device),
                0)
    padded, _ = _pad_to_block(stack.to(torch.float32))
    q, s = quantize_stack_kernel(padded)
    return q, s, D


def aggregate_quantized(
    q: torch.Tensor,
    scales: torch.Tensor,
    D: Optional[int] = None,
    method: str = "fedavg",
    weights: Optional[Any] = None,
    trim: int = 1,
    quantize_out: bool = False,
):
    """Fused one-pass aggregation straight from the chain's int8 blocks.

    q: (K, Dpad) int8, scales: (K, Dpad // BLOCK_D) f32, D: true dimension.
    Returns (D,) f32 — or, with ``quantize_out``, ``(q_out (Dpad,) int8,
    out_scales, D)`` ready for chain storage."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r} (want one of {METHODS})")
    K, Dpad = q.shape
    true_d = Dpad if D is None else D
    w = normalize_weights(K, weights, q.device)
    out = fused_agg_kernel(q, scales, w, method=method, trim=trim,
                           quantize_out=quantize_out)
    if quantize_out:
        q_out, s_out = out
        return q_out, s_out, true_d
    return out[:true_d]


def candidates_from_quantized(base: torch.Tensor, q: torch.Tensor,
                              scales: torch.Tensor,
                              D: Optional[int] = None) -> torch.Tensor:
    """The (K, D) f32 candidate stack ``base + dequant(q_k)`` straight from
    the chain's int8 rows: base (D,) f32, q (K, Dpad) int8, scales
    (K, Dpad // BLOCK_D).  One int8 read, the f32 update stack never
    exists."""
    Dpad = q.shape[1]
    true_d = Dpad if D is None else D
    padded, _ = _pad_to_block(base.to(torch.float32))
    return fused_candidates_kernel(padded, q, scales)[:, :true_d]


# ----------------------------------------------------------------------
# tree adapters
# ----------------------------------------------------------------------
def quantize_pytree(tree):
    """Flatten (sorted-key leaf order) + quantize a tree for the chain."""
    flat, unravel = ravel_pytree(tree)
    q, s, D = quantize(flat)
    return {"q": q, "scales": s, "d": D}, unravel


def dequantize_pytree(blob, unravel):
    return unravel(dequantize(blob["q"], blob["scales"], blob["d"]))


class Int8UpdateCodec:
    """Chain payload codec: update tree <-> int8 blob dict.

    The unravel structure is fixed at construction from an example tree
    (all BFLC updates share the model's structure), so decode needs no
    side channel."""

    def __init__(self, example_tree):
        flat, self._unravel = ravel_pytree(example_tree)
        self.dim = int(flat.shape[0])

    def encode(self, tree):
        blob, _ = quantize_pytree(tree)
        return blob

    def decode(self, blob):
        return dequantize_pytree(blob, self._unravel)

    def unravel(self, flat: torch.Tensor):
        return self._unravel(flat)
