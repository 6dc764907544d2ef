"""Device selection and host <-> device copies for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: a CUDA
device with no CUDA present raises rather than falling back.  On CUDA the
port keeps float32 as float32: cuDNN would otherwise run float32
convolutions in TF32 (about three decimal digits), so both TF32 switches
are turned off here, for the whole process.

The round's stages leave device work in flight (``fl/async_engine.py``
overlaps one cohort's training with the previous cohort's committee
work), so no stage copies between host and card with a blocking copy:
PyTorch's blocking copy waits for everything queued on the stream first.
``to_device`` stages host arrays through pinned memory and copies them
with ``non_blocking=True``; ``HostCopy`` starts a device result's copy
into pinned memory and waits on the event recorded after it, never on
the device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.spans import count, span


def resolve_device(device="cuda") -> torch.device:
    """``device`` checked and set up.  A numbered card (``"cuda:<i>"``, a
    rank's device) becomes the process's current CUDA device, because the
    kernels launch on the current device's stream."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port "
                "on the CPU"
            )
        if dev.index is not None:
            if dev.index >= torch.cuda.device_count():
                raise ValueError(f"device {dev}: only "
                                 f"{torch.cuda.device_count()} CUDA devices")
            torch.cuda.set_device(dev)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"device {dev} is neither 'cuda' nor 'cpu'")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def to_device(array: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on ``device``.  On CUDA the array is staged
    in pinned memory and copied with ``non_blocking=True``: the call does
    not wait for the stream, and the stream orders the copy before every
    kernel queued after it.  PyTorch's pinned-memory cache keeps the
    staging buffer until the copy has run.  In a recorded round the call
    is the span ``h2d`` and counts the array's bytes (``h2d_bytes``).  A
    tensor already on ``device`` is returned as it is: nothing is copied
    or counted."""
    dev = torch.device(device)
    if isinstance(array, torch.Tensor) and array.device.type == dev.type \
            and dev.index in (None, array.device.index):
        return array
    with span("h2d"):
        array = np.ascontiguousarray(array)
        count("h2d_bytes", array.nbytes)
        t = torch.from_numpy(array)
        if dev.type == "cuda":
            return t.pin_memory().to(dev, non_blocking=True)
        return t.to(dev)


class HostCopy:
    """A tensor's copy on its way to host memory.

    On CUDA the copy goes into pinned memory with ``non_blocking=True`` and
    an event is recorded on the stream right after it; ``wait()`` blocks on
    that event alone, not on work queued after it, and returns the host
    tensor.  The host buffer is read only through ``wait()``: reading it
    before the event has passed would race the copy.  A CPU tensor is its
    own host copy."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._host = t

    def wait(self) -> torch.Tensor:
        if self._event is not None:
            self._event.synchronize()
        return self._host
