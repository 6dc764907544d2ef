"""Public wrappers around the kernels: pad once, dispatch, adapt trees.

Port of ``repro/kernels/ops.py``.  Callers hand over an f32 vector or (K, D) stack, or the chain's quantized
representation (int8 stack + per-tile scales); padding to the tile
boundary happens exactly once here, and the kernel wrappers below pick
the CUDA kernel or the plain version by the tensor's device.  The f32
aggregation kernels reduce each lane on its own and mask the ragged edge,
so their stacks go in unpadded.

  aggregate(stack, method=..., weights=..., trim=...)   f32 path
  fedavg_agg / cwmed / trimmed_mean                     its three kernels
  quantize(x) / dequantize(q, scales, D)                codec, one vector
  quantize_stack(stack)                                 round codec, K rows
  quantize_into(x, q_row, s_row)                        one row of a stack
  aggregate_quantized(q, scales, D, method=...)         fused int8 path
  candidates_from_quantized(base, q, scales, D)         int8 scoring path
  Int8UpdateCodec                                       chain payload codec

The sharded round engine builds its codec programs once per mesh through
the factories at the bottom (``make_quantize_stack_sharded`` /
``make_aggregate_quantized_sharded``): each rank launches the same kernels
on its own D-slice of the int8 stack, padded to ``padded_dim_sharded`` so
that every slice is tile-aligned and its scales are the single-device
codec's.
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
from repro_torch.launch.shardings import round_engine_pspecs
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


def quantize_into(x: torch.Tensor, q_row: torch.Tensor,
                  s_row: torch.Tensor) -> None:
    """(D,) f32 quantized into a preallocated row: q_row (Dpad,) int8 and
    s_row (Dpad // BLOCK_D,) f32, e.g. row i of a round's stack.  Tiles are
    row-local, so the row holds the bits ``quantize_stack`` gives it in a
    stack of any K."""
    padded, _ = _pad_to_block(x.to(torch.float32))
    quantize_kernel(padded, out=(q_row, s_row))


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
# sharded engine (one program set per mesh, built once)
# ----------------------------------------------------------------------
def padded_dim_sharded(d: int, shards: int) -> int:
    """Smallest multiple of ``shards * BLOCK_D`` >= d.

    Padding to this boundary keeps every D-slice tile-aligned, so each
    slice's quantization tiles (and their scales) coincide with the
    single-device tiles: the sharded codec differs from the single-device
    one only in how many all-zero tiles trail the data."""
    chunk = BLOCK_D * shards
    return d + (-d) % chunk


def make_quantize_stack_sharded(mesh):
    """Sharding-aware round codec: ``quantize(stack)`` takes the (K, D) f32
    stack every rank holds, pads D to ``padded_dim_sharded(D, ranks)`` and
    quantizes this rank's (K, Dpad / ranks) slice in one ``quantize_stack``
    launch.  Returns the slice's (q, scales), split as
    ``round_engine_pspecs()["dshard"]`` names; tiles are independent, so
    no rank waits for another."""
    split = round_engine_pspecs()["dshard"]

    def quantize_sharded(stack: torch.Tensor):
        D = stack.shape[1]
        padded = F.pad(stack.to(torch.float32),
                       (0, padded_dim_sharded(D, mesh.size) - D))
        return quantize_stack_kernel(mesh.shard(padded, split).contiguous())

    return quantize_sharded


def make_aggregate_quantized_sharded(mesh, method: str = "fedavg",
                                     trim: int = 1):
    """Sharded fused aggregation: ``aggregate(q, scales, weights)`` takes the
    (K, Dpad) int8 stack and scales every rank holds and runs the fused
    int8 -> dequantize -> reduce kernel on this rank's D-slice.  Returns the
    slice's (Dpad / ranks,) f32 reduction (``round_engine_pspecs()["dvec"]``),
    which the aggregator gathers into the model block.  ``weights`` must
    already be normalized (``normalize_weights``): every rank weighs the
    rows alike."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r} (want one of {METHODS})")
    split = round_engine_pspecs()["dshard"]

    def aggregate_sharded(q: torch.Tensor, scales: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
        return fused_agg_kernel(
            mesh.shard(q, split).contiguous(),
            mesh.shard(scales, split).contiguous(),
            weights.to(torch.float32).contiguous(), method=method, trim=trim,
        )

    return aggregate_sharded


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
