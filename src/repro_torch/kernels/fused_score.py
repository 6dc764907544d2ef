"""Fused candidate rebuild for committee scoring from int8 update rows.

Port of ``repro/kernels/fused_score.py`` (``fused_candidates_kernel``).
The committee scores candidate models ``base + dequant(q_k)``; this pass
reads each int8 row and its per-tile scales once and writes the f32
candidate rows once, so the f32 update stack never exists.  Each lane is
``fma(q, s, base)``, rounded once, as the reference compiles it (see
``repro_torch.numerics``).

``fused_candidates_kernel`` dispatches on the stack's device: a CPU tensor
goes to ``fused_candidates_ref``, a CUDA tensor launches the kernel of
``csrc/fused_score.cu`` or raises.  Launches are counted in
``fused_candidates_kernel.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.tiling import BLOCK_D
from repro_torch.numerics import fma_f32


def fused_candidates_ref(base: torch.Tensor, qstack: torch.Tensor,
                         scales: torch.Tensor) -> torch.Tensor:
    """(D,) f32 + (K, D) int8 + (K, D // BLOCK_D) f32 -> (K, D) f32."""
    K, D = qstack.shape
    s = scales.repeat_interleave(BLOCK_D, dim=1)
    return fma_f32(qstack.to(torch.float32), s, base.reshape(1, D))


def fused_candidates_kernel(base: torch.Tensor, qstack: torch.Tensor,
                            scales: torch.Tensor) -> torch.Tensor:
    """base: (D,) f32; qstack: (K, D) int8 with D % BLOCK_D == 0; scales:
    (K, D // BLOCK_D) f32.  Returns the (K, D) f32 candidate rows."""
    if qstack.dtype != torch.int8 or qstack.dim() != 2:
        raise TypeError(f"qstack must be 2-D int8, got {qstack.dtype} "
                        f"{tuple(qstack.shape)}")
    K, D = qstack.shape
    if K == 0 or D == 0 or D % BLOCK_D:
        raise ValueError(f"qstack shape {(K, D)}: need K >= 1 and D a "
                         f"positive multiple of {BLOCK_D}")
    if base.shape != (D,) or base.dtype != torch.float32:
        raise ValueError(f"base {tuple(base.shape)} {base.dtype}, want "
                         f"({D},) float32")
    if scales.shape != (K, D // BLOCK_D) or scales.dtype != torch.float32:
        raise ValueError(f"scales {tuple(scales.shape)} {scales.dtype}, want "
                         f"{(K, D // BLOCK_D)} float32")
    if qstack.device.type == "cpu":
        return fused_candidates_ref(base, qstack, scales)
    _build.require_cuda(qstack, base, scales, vector_loaded=(qstack, base))
    out = torch.empty((K, D), dtype=torch.float32, device=qstack.device)
    lib = _build.load("fused_score")
    code = lib.repro_fused_candidates(
        base.data_ptr(), qstack.data_ptr(), scales.data_ptr(), out.data_ptr(),
        K, D // BLOCK_D, _build.stream_handle(qstack),
    )
    _build.check(lib, code, "repro_fused_candidates")
    fused_candidates_kernel.launches += 1
    return out


fused_candidates_kernel.launches = 0
