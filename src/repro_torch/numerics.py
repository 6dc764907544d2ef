"""The reference's float32 rounding, where PyTorch's would differ.

XLA rewrites a division by a constant into a multiply by the constant's
float32 reciprocal.  So the reference's compiled code computes a tile's
int8 scale as ``amax * f32(1/127)`` and a mean of n values as
``sum * f32(1/n)``, which can differ from a true division in the last bit.
The port multiplies by the same reciprocal wherever the reference does,
so chain scales, trimmed means and accuracies agree bit for bit.

XLA also fuses a multiply feeding an add into one fused multiply-add,
rounded once: the f32 and fused fedavg sums compile to the chain
``acc = fma(x_k, w_k, acc)``, and the fused candidate rebuild
``base + q * s`` to ``fma(q, s, base)``.  Multiply-then-add (two
roundings) differs on many lanes, so the kernels use ``__fmaf_rn`` and
the plain versions ``fma_f32``.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def recip_f32(n: float) -> float:
    """f32(1 / n), correctly rounded in float32, as a Python float (exact
    in float32, so multiplying a float32 tensor by it rounds once)."""
    return float(np.float32(1.0) / np.float32(n))


INV_127 = recip_f32(127.0)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 tensors (broadcast), rounded once to
    float32, as ``__fmaf_rn`` computes it.  PyTorch has no fma op, so it
    is taken in float64: ``a * b`` is exact there (24 + 24 bits), and the
    double sum ``s`` is corrected where rounding it to float32 alone would
    be wrong, which is only when ``s`` lies exactly on a float32 midpoint
    while the exact sum does not (its two-sum error says which side)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    f = s.float()
    fd = f.double()
    toward = torch.where(s > fd, math.inf, -math.inf).to(torch.float32)
    g = torch.nextafter(f, toward)
    on_mid = (s != fd) & ((fd + g.double()) * 0.5 == s) & (err != 0)
    past = (err > 0) == (s > fd)        # the exact sum lies beyond s from f
    return torch.where(on_mid & past, g, f)
