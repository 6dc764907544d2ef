"""The precision the reference computes its products in.

``f64`` is the reference the trainers' updates are judged against:
float64, with no TF32 anywhere.  ``f32`` is the configurations' stated
precision: float32 with TF32 off.  ``tf32`` is the control, the nearest
precision below it.  On a card it turns on the TF32 switches of cuBLAS
and cuDNN for the block; on the CPU, which has no TF32, the reference
rounds every product's operands to TF32's 10-bit mantissa itself (round
to nearest), which is what the tensor cores do to the operands of a
forward product.
"""
from __future__ import annotations

import contextlib

import torch

KINDS = ("f64", "f32", "tf32")
_SPLIT = float(2 ** 13 + 1)     # Veltkamp's constant: 24 - 13 = 11 bits kept


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to 11 significant bits (TF32's 10 and the implicit
    one), by Veltkamp's split; exact arithmetic gives it a gradient of 1."""
    t = x * _SPLIT
    return t - (t - x)


class Precision:
    def __init__(self, kind: str, device):
        if kind not in KINDS:
            raise ValueError(f"precision {kind!r}: want one of {KINDS}")
        self.kind = kind
        self.dtype = torch.float64 if kind == "f64" else torch.float32
        self.emulate = kind == "tf32" and torch.device(device).type == "cpu"

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        return tf32_round(x) if self.emulate else x

    @contextlib.contextmanager
    def scope(self):
        cuda = torch.backends.cuda.matmul, torch.backends.cudnn
        saved = cuda[0].allow_tf32, cuda[1].allow_tf32
        cuda[0].allow_tf32 = cuda[1].allow_tf32 = self.kind == "tf32"
        try:
            yield self
        finally:
            cuda[0].allow_tf32, cuda[1].allow_tf32 = saved
