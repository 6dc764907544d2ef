"""Per-tile symmetric int8 quantize / dequantize: the chain's update codec.

Port of ``repro/kernels/quantize.py``.  Each wrapper takes tile-aligned
tensors (D a multiple of BLOCK_D) and dispatches on the tensor's device:
a CPU tensor goes to the plain PyTorch version beside it (the staged math
of ``repro/kernels/ref.py``); a CUDA tensor launches the hand-written
kernel of ``csrc/quantize.cu`` or raises.  Each wrapper counts its kernel
launches in ``<wrapper>.launches``.

scale = max|x| * f32(1/127) per tile (1.0 for an all-zero tile; the
reference's compiled ``amax / 127.0``, see ``repro_torch.numerics``) and
q = clip(round_half_even(x / scale), -127, 127) with an IEEE division:
with ``torch.round`` (half to even) this reproduces the reference's q and
scales bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.tiling import BLOCK_D
from repro_torch.numerics import INV_127


# ----------------------------------------------------------------------
# plain PyTorch versions (the reference's ref.quantize*_ref / dequantize*)
# ----------------------------------------------------------------------
def quantize_stack_ref(stack: torch.Tensor):
    """(K, D) f32 -> (q (K, D) int8, scales (K, D // BLOCK_D) f32)."""
    K, D = stack.shape
    xb = stack.to(torch.float32).reshape(K, -1, BLOCK_D)
    amax = xb.abs().amax(dim=2)
    scales = torch.where(amax > 0, amax * INV_127, torch.ones_like(amax))
    q = torch.round(xb / scales[:, :, None]).clamp(-127, 127).to(torch.int8)
    return q.reshape(K, D), scales


def quantize_ref(x: torch.Tensor):
    """(D,) f32 -> (q (D,) int8, scales (D // BLOCK_D,) f32)."""
    q, s = quantize_stack_ref(x.reshape(1, -1))
    return q[0], s[0]


def dequantize_stack_ref(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(K, D) int8 + (K, D // BLOCK_D) scales -> (K, D) f32."""
    K, D = q.shape
    return (
        q.reshape(K, -1, BLOCK_D).to(torch.float32) * scales[:, :, None]
    ).reshape(K, D)


def dequantize_ref(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return dequantize_stack_ref(q.reshape(1, -1), scales.reshape(1, -1))[0]


# ----------------------------------------------------------------------
# wrappers: CPU -> plain version, CUDA -> kernel
# ----------------------------------------------------------------------
def _check_tiled(t: torch.Tensor, dtype: torch.dtype, ndim: int, what: str):
    if t.dtype != dtype:
        raise TypeError(f"{what}: want {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: want {ndim}-D, got shape {tuple(t.shape)}")
    if t.shape[-1] == 0 or t.shape[-1] % BLOCK_D:
        raise ValueError(
            f"{what}: last dim {t.shape[-1]} is not a positive multiple of "
            f"{BLOCK_D} (pad first: repro_torch.kernels.ops)"
        )


def _launch_quantize_rows(stack: torch.Tensor, q=None, s=None):
    K, D = stack.shape
    _build.require_cuda(stack, vector_loaded=(stack,))
    if q is None:
        q = torch.empty((K, D), dtype=torch.int8, device=stack.device)
        s = torch.empty((K, D // BLOCK_D), dtype=torch.float32,
                        device=stack.device)
    lib = _build.load("quantize")
    code = lib.repro_quantize_rows(
        stack.data_ptr(), q.data_ptr(), s.data_ptr(), K, D // BLOCK_D,
        _build.stream_handle(stack),
    )
    _build.check(lib, code, "repro_quantize_rows")
    return q, s


def quantize_stack_kernel(stack: torch.Tensor):
    """(K, D) f32, D % BLOCK_D == 0 -> (q (K, D) int8, scales (K, nblk))."""
    _check_tiled(stack, torch.float32, 2, "quantize_stack_kernel")
    if stack.device.type == "cpu":
        return quantize_stack_ref(stack)
    out = _launch_quantize_rows(stack)
    quantize_stack_kernel.launches += 1
    return out


quantize_stack_kernel.launches = 0


def quantize_kernel(x: torch.Tensor, out=None):
    """(D,) f32 -> (q (D,) int8, scales (D // BLOCK_D,) f32): the K = 1
    launch of the stack kernel.  ``out``: a (q, scales) pair of that shape
    (contiguous rows of a stack, say) written in place and returned."""
    _check_tiled(x, torch.float32, 1, "quantize_kernel")
    if out is not None:
        q, s = out
        if (q.shape != x.shape or q.dtype != torch.int8
                or s.shape != (x.shape[0] // BLOCK_D,)
                or s.dtype != torch.float32 or not q.is_contiguous()
                or not s.is_contiguous()):
            raise ValueError(
                f"quantize_kernel: out {tuple(q.shape)} {q.dtype}, "
                f"{tuple(s.shape)} {s.dtype} does not fit x {tuple(x.shape)}")
    if x.device.type == "cpu":
        if out is None:
            return quantize_ref(x)
        rq, rs = quantize_ref(x)
        return q.copy_(rq), s.copy_(rs)
    if out is None:
        q, s = _launch_quantize_rows(x.reshape(1, -1))
        q, s = q[0], s[0]
    else:
        _launch_quantize_rows(x.reshape(1, -1), q.view(1, -1), s.view(1, -1))
    quantize_kernel.launches += 1
    return q, s


quantize_kernel.launches = 0


def dequantize_kernel(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(D,) int8 + (D // BLOCK_D,) f32 -> (D,) f32."""
    _check_tiled(q, torch.int8, 1, "dequantize_kernel")
    if scales.shape != (q.shape[0] // BLOCK_D,) or scales.dtype != torch.float32:
        raise ValueError(
            f"dequantize_kernel: scales {tuple(scales.shape)} {scales.dtype} "
            f"do not match q {tuple(q.shape)}"
        )
    if q.device.type == "cpu":
        return dequantize_ref(q, scales)
    _build.require_cuda(q, scales, vector_loaded=(q,))
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lib = _build.load("quantize")
    code = lib.repro_dequantize(
        q.data_ptr(), scales.data_ptr(), out.data_ptr(), q.numel(),
        _build.stream_handle(q),
    )
    _build.check(lib, code, "repro_dequantize")
    dequantize_kernel.launches += 1
    return out


dequantize_kernel.launches = 0
