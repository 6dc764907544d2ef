"""Fused int8 aggregation: the BFLC round's aggregation in one pass.

Port of ``repro/kernels/fused_agg.py`` (with the sort helpers it uses from
``repro/kernels/cwmed.py``).  The K chain-format update rows (int8 plus a
scale per 2048-lane tile) are dequantized in registers and reduced per lane
— weighted sum (fedavg), median (cwmed) or trimmed mean — and with
``quantize_out`` each output tile is requantized in the same pass, so the
f32 (K, D) stack never exists in device memory.

``fused_agg_kernel`` dispatches on the stack's device: a CPU tensor goes to
``fused_agg_ref`` (dequantize the whole stack, then reduce — the staged
math of ``repro/kernels/ref.py``); a CUDA tensor launches the kernel of
``csrc/fused_agg.cu`` or raises.  Launches are counted in
``fused_agg_kernel.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quantize import dequantize_stack_ref, quantize_ref
from repro_torch.kernels.tiling import BLOCK_D
from repro_torch.numerics import recip_f32

METHODS = ("fedavg", "cwmed", "trimmed_mean")
# largest K the sort methods take (per-lane array in csrc/fused_agg.cu)
MAX_SORT_K = 64


def median_of_sorted(rows: torch.Tensor) -> torch.Tensor:
    K = rows.shape[0]
    if K % 2 == 1:
        return rows[K // 2]
    return 0.5 * (rows[K // 2 - 1] + rows[K // 2])


def trimmed_mean_of_sorted(rows: torch.Tensor, trim: int) -> torch.Tensor:
    """Sequential sum of the kept rows times the f32 reciprocal of their
    count (the reference's ``trimmed_mean_of_sorted`` as compiled)."""
    keep = rows[trim : rows.shape[0] - trim]
    acc = keep[0]
    for r in keep[1:]:
        acc = acc + r
    return acc * recip_f32(keep.shape[0])


def reduce_rows(stack: torch.Tensor, weights: torch.Tensor, method: str,
                trim: int) -> torch.Tensor:
    """(K, D) f32 -> (D,).

    fedavg accumulates one row at a time with a fused multiply-add,
    ``acc = fma(stack[k], w[k], acc)``, as the kernel and the reference's
    compiled sum do.  PyTorch has no fma op, so it is taken in float64: the
    product of two floats is exact there, and rounding the double sum to
    float32 differs from one fused rounding only when the sum lands on a
    float32 rounding midpoint (about one case in 2**29).  The sort methods
    sort each lane's K values."""
    if method == "fedavg":
        acc = torch.zeros_like(stack[0], dtype=torch.float64)
        for k in range(stack.shape[0]):
            acc = (stack[k].double() * weights[k].double() + acc).float().double()
        return acc.float()
    rows = torch.sort(stack, dim=0).values
    if method == "cwmed":
        return median_of_sorted(rows)
    return trimmed_mean_of_sorted(rows, trim)


def fused_agg_ref(q, scales, weights, method: str = "fedavg", trim: int = 1,
                  quantize_out: bool = False):
    """Staged plain version: dequantize the stack to f32, then reduce."""
    agg = reduce_rows(dequantize_stack_ref(q, scales),
                      weights.to(torch.float32), method, trim)
    return quantize_ref(agg) if quantize_out else agg


def _check(q, scales, weights, method: str, trim: int) -> None:
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r} (want one of {METHODS})")
    if q.dtype != torch.int8 or q.dim() != 2:
        raise TypeError(f"qstack must be 2-D int8, got {q.dtype} {tuple(q.shape)}")
    K, D = q.shape
    if K == 0 or D == 0 or D % BLOCK_D:
        raise ValueError(f"qstack shape {(K, D)}: need K >= 1 and D a "
                         f"positive multiple of {BLOCK_D}")
    if scales.shape != (K, D // BLOCK_D) or scales.dtype != torch.float32:
        raise ValueError(f"scales {tuple(scales.shape)} {scales.dtype}, want "
                         f"{(K, D // BLOCK_D)} float32")
    if weights.shape != (K,) or weights.dtype != torch.float32:
        raise ValueError(f"weights {tuple(weights.shape)} {weights.dtype}, "
                         f"want ({K},) float32")
    if method == "trimmed_mean" and not 0 <= 2 * trim < K:
        raise ValueError(f"trim={trim} too large for K={K}")
    if method != "fedavg" and K > MAX_SORT_K:
        raise ValueError(f"{method} takes K <= {MAX_SORT_K}, got {K}")


def fused_agg_kernel(q: torch.Tensor, scales: torch.Tensor,
                     weights: torch.Tensor, *, method: str = "fedavg",
                     trim: int = 1, quantize_out: bool = False):
    """q: (K, D) int8; scales: (K, D // BLOCK_D) f32; weights: (K,) f32
    normalized (read by fedavg only).

    Returns (D,) f32, or (q (D,) int8, out_scales (D // BLOCK_D,) f32) with
    ``quantize_out``."""
    _check(q, scales, weights, method, trim)
    if q.device.type == "cpu":
        return fused_agg_ref(q, scales, weights, method, trim, quantize_out)
    _build.require_cuda(q, scales, weights, vector_loaded=(q,))
    K, D = q.shape
    nblk = D // BLOCK_D
    dev = q.device
    if quantize_out:
        out = None
        q_out = torch.empty((D,), dtype=torch.int8, device=dev)
        s_out = torch.empty((nblk,), dtype=torch.float32, device=dev)
        ptrs = (0, q_out.data_ptr(), s_out.data_ptr())
    else:
        out = torch.empty((D,), dtype=torch.float32, device=dev)
        ptrs = (out.data_ptr(), 0, 0)
    lib = _build.load("fused_agg")
    code = lib.repro_fused_agg(
        q.data_ptr(), scales.data_ptr(), weights.data_ptr(), *ptrs, K, nblk,
        METHODS.index(method), trim, int(quantize_out),
        _build.stream_handle(q),
    )
    _build.check(lib, code, "repro_fused_agg")
    fused_agg_kernel.launches += 1
    return (q_out, s_out) if quantize_out else out


fused_agg_kernel.launches = 0
