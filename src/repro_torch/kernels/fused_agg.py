"""Fused int8 aggregation: the BFLC round's aggregation in one pass.

Port of ``repro/kernels/fused_agg.py``; its plain version shares the f32
reductions of ``fedavg_agg.py`` and ``cwmed.py``.  The K chain-format
update rows (int8 plus a scale per 2048-lane tile) are dequantized in
registers and reduced per lane
— weighted sum (fedavg), median (cwmed) or trimmed mean — and with
``quantize_out`` each output tile is requantized in the same pass, so the
f32 (K, D) stack never exists in device memory.

Every method takes any K, as the reference's does: on the card the sorts
run in registers for K <= 32 and in shared memory above that, and only a
K whose column does not fit one lane's shared memory is refused.

``fused_agg_kernel`` dispatches on the stack's device: a CPU tensor goes to
``fused_agg_ref`` (dequantize the whole stack, then reduce — the staged
math of ``repro/kernels/ref.py``); a CUDA tensor launches the kernel of
``csrc/fused_agg.cu`` or raises.  Launches are counted in
``fused_agg_kernel.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cwmed import cwmed_ref, trimmed_mean_ref
from repro_torch.kernels.fedavg_agg import fedavg_agg_ref
from repro_torch.kernels.quantize import dequantize_stack_ref, quantize_ref
from repro_torch.kernels.tiling import BLOCK_D

METHODS = ("fedavg", "cwmed", "trimmed_mean")


def reduce_rows(stack: torch.Tensor, weights: torch.Tensor, method: str,
                trim: int) -> torch.Tensor:
    """(K, D) f32 -> (D,) by the f32 kernels' plain versions: fedavg's
    fused multiply-add chain, or a per-lane sort for the other two."""
    if method == "fedavg":
        return fedavg_agg_ref(stack, weights)
    if method == "cwmed":
        return cwmed_ref(stack)
    return trimmed_mean_ref(stack, trim)


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
    _build.check(lib, code, f"repro_fused_agg (K={K}; a sort whose K-deep "
                            f"column does not fit in shared memory is refused)")
    fused_agg_kernel.launches += 1
    return (q_out, s_out) if quantize_out else out


fused_agg_kernel.launches = 0
