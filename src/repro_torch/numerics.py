"""The reference's float32 rounding, where PyTorch's would differ.

XLA rewrites a division by a constant into a multiply by the constant's
float32 reciprocal.  So the reference's compiled code computes a tile's
int8 scale as ``amax * f32(1/127)`` and a mean of n values as
``sum * f32(1/n)``, which can differ from a true division in the last bit.
The port multiplies by the same reciprocal wherever the reference does,
so chain scales, trimmed means and accuracies agree bit for bit.
"""
from __future__ import annotations

import numpy as np


def recip_f32(n: float) -> float:
    """f32(1 / n), correctly rounded in float32, as a Python float (exact
    in float32, so multiplying a float32 tensor by it rounds once)."""
    return float(np.float32(1.0) / np.float32(n))


INV_127 = recip_f32(127.0)
