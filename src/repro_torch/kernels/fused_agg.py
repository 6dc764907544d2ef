"""Fused int8 aggregation: the BFLC round's aggregation in one pass.

Port of ``repro/kernels/fused_agg.py``; its plain version shares the f32
reductions of ``fedavg_agg.py`` and ``cwmed.py``.  The K chain-format
update rows (int8 plus a scale per 2048-lane tile) are dequantized in
registers and reduced per lane
— weighted sum (fedavg), median (cwmed) or trimmed mean — and with
``quantize_out`` each output tile is requantized in the same pass, so the
f32 (K, D) stack never exists in device memory.

Every method takes any K, as the reference's does: on the card the sorts
run in registers for K <= 32, as runs of 32 merged through shared memory
for 33 <= K <= 128 and by an insertion sort in shared memory above that,
and only a K whose column does not fit one lane's shared memory is
refused.  ``fused_design`` asks the C entry which design it takes.  With
``quantize_out`` the run merge is two launches (the merge into f32
scratch, then a requantizing pass), counted as one call.

``fused_agg_kernel`` dispatches on the stack's device: a CPU tensor goes to
``fused_agg_ref`` (dequantize the whole stack, then reduce — the staged
math of ``repro/kernels/ref.py``); a CUDA tensor launches the kernel of
``csrc/fused_agg.cu`` or raises.  Launches are counted in
``fused_agg_kernel.launches``, and by the design that ran in
``fused_agg_kernel.designs``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cwmed import (
    count_launch, cwmed_ref, design_name, trimmed_mean_ref,
)
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


@functools.lru_cache(maxsize=None)
def _fused_path(K: int, method: str, quantize_out: bool,
                insertion: bool) -> tuple:
    """repro_fused_agg's {design, size, needs scratch} for K rows; launches
    nothing."""
    path = (ctypes.c_int * 3)()
    lib = _build.load("fused_agg")
    _build.check(lib, lib.repro_fused_agg(
        None, None, None, None, None, None, K, 1, METHODS.index(method), 0,
        int(quantize_out), int(insertion), ctypes.addressof(path), None),
        f"repro_fused_agg (K={K}, {method})")
    return tuple(path)


def fused_design(K: int, method: str, insertion: bool = False) -> str:
    """The design repro_fused_agg takes for K rows (chosen in
    ``csrc/sort_net.cuh`` sort_path; "fedavg" for fedavg), as text;
    launches nothing."""
    return design_name(*_fused_path(K, method, False, insertion)[:2])


def _launch_fused(q, scales, weights, method: str, trim: int,
                  quantize_out: bool, insertion: bool = False):
    """repro_fused_agg, with ``insertion`` the shared-memory insertion sort
    at any K (to time it beside the design K picks; refused for fedavg);
    counts no launch (fused_agg_kernel does)."""
    _build.require_cuda(q, scales, weights, vector_loaded=(q,))
    K, D = q.shape
    nblk = D // BLOCK_D
    dev = q.device
    if quantize_out:
        q_out = torch.empty((D,), dtype=torch.int8, device=dev)
        s_out = torch.empty((nblk,), dtype=torch.float32, device=dev)
        # f32 scratch where the design writes its lanes, then requantizes
        scratch = _fused_path(K, method, True, insertion)[2]
        out = torch.empty((D,), dtype=torch.float32, device=dev) if scratch else None
        ptrs = (None if out is None else out.data_ptr(), q_out.data_ptr(),
                s_out.data_ptr())
    else:
        out = torch.empty((D,), dtype=torch.float32, device=dev)
        ptrs = (out.data_ptr(), None, None)
    lib = _build.load("fused_agg")
    code = lib.repro_fused_agg(
        q.data_ptr(), scales.data_ptr(), weights.data_ptr(), *ptrs, K, nblk,
        METHODS.index(method), trim, int(quantize_out), int(insertion), None,
        _build.stream_handle(q),
    )
    _build.check(lib, code, f"repro_fused_agg (K={K}; a sort whose K-deep "
                            f"column does not fit one lane's shared memory "
                            f"is refused)")
    return (q_out, s_out) if quantize_out else out


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
    result = _launch_fused(q, scales, weights, method, trim, quantize_out)
    count_launch(fused_agg_kernel, fused_design(q.shape[0], method))
    return result


fused_agg_kernel.launches = 0
fused_agg_kernel.designs = {}
