"""Weighted sum of K f32 update rows: the f32 fedavg aggregation.

Port of ``repro/kernels/fedavg_agg.py`` (``fedavg_agg_kernel``).  The
weights are taken as given (``ops.aggregate`` normalizes them).  The
reference's ``sum(x * w, axis=0)`` compiles to the chain
``acc = fma(x_k, w_k, acc)`` over k in order, and so do the CUDA kernel of
``csrc/f32_agg.cu`` and the plain version here (``repro_torch.numerics``),
so the three agree bit for bit given the same weights.

``fedavg_agg_kernel`` takes any (K, D) f32 stack (the kernel masks the
ragged edge) and dispatches on the stack's device: a CPU tensor goes to
``fedavg_agg_ref``, a CUDA tensor launches the kernel or raises.  Launches
are counted in ``fedavg_agg_kernel.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.numerics import fma_f32


def fedavg_agg_ref(stack: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(K, D) f32 x (K,) f32 -> (D,): acc = fma(stack[k], w[k], acc)."""
    acc = torch.zeros_like(stack[0])
    for k in range(stack.shape[0]):
        acc = fma_f32(stack[k], weights[k], acc)
    return acc


def fedavg_agg_kernel(stack: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """stack: (K, D) f32; weights: (K,) f32, used as given.  Returns (D,)."""
    _build.check_f32_stack(stack, "fedavg_agg_kernel")
    K, D = stack.shape
    if weights.shape != (K,) or weights.dtype != torch.float32:
        raise ValueError(f"weights {tuple(weights.shape)} {weights.dtype}, "
                         f"want ({K},) float32")
    if stack.device.type == "cpu":
        return fedavg_agg_ref(stack, weights)
    _build.require_cuda(stack, weights)
    out = torch.empty((D,), dtype=torch.float32, device=stack.device)
    lib = _build.load("f32_agg")
    code = lib.repro_fedavg_agg(stack.data_ptr(), weights.data_ptr(),
                                out.data_ptr(), K, D,
                                _build.stream_handle(stack))
    _build.check(lib, code, "repro_fedavg_agg")
    fedavg_agg_kernel.launches += 1
    return out


fedavg_agg_kernel.launches = 0
