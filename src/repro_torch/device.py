"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: a CUDA
device with no CUDA present raises rather than falling back.  On CUDA the
port keeps float32 as float32: cuDNN would otherwise run float32
convolutions in TF32 (about three decimal digits), so both TF32 switches
are turned off here, for the whole process.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port "
                "on the CPU"
            )
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"device {dev} is neither 'cuda' nor 'cpu'")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
