"""Continuous-batching inference serving off the latest chain model.

Port of ``repro.serve``."""
from repro_torch.serve.engine import ServeEngine, ServeReport, VirtualClock, WallClock
from repro_torch.serve.params import (
    CKPT_RE,
    ChainParamSource,
    CheckpointParamSource,
    checkpoint_name,
)
from repro_torch.serve.scheduler import FifoScheduler
from repro_torch.serve.slots import Request, RequestResult, SlotTable
from repro_torch.serve.trace import aggregate, make_poisson_trace

__all__ = [
    "CKPT_RE",
    "ChainParamSource",
    "CheckpointParamSource",
    "FifoScheduler",
    "Request",
    "RequestResult",
    "ServeEngine",
    "ServeReport",
    "SlotTable",
    "VirtualClock",
    "WallClock",
    "aggregate",
    "checkpoint_name",
    "make_poisson_trace",
]
