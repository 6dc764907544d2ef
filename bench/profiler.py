"""Reads a torch.profiler trace of whole rounds into the benchmark's numbers.

Copied from ``chip_smoke.py`` (``merged``, ``StageRange``,
``phase_profile``) and frozen here.  The device is busy where any device
operation runs: busy time is the union of the device events' intervals
(one stream's kernels overlap where a launch starts before the one ahead
of it ends).  Device time by name sums each event's own duration.  Every
stage of the round runs inside a host range ``stage.<timing key>`` that
ends after a device synchronize, so an idle gap of the device can be
named by the stage the host was in.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

# the pipeline's stage slots, by the timing key RoundPipeline files them under
STAGES = {"sampler": "sample", "local_trainer": "train", "validator": "validate",
          "packer": "pack", "aggregator": "aggregate", "elector": "elect",
          "rewarder": "reward"}
ROUND_RANGE = "bench.round"
TOP = 10                 # entries of each breakdown list
NAME_CHARS = 160         # a kernel's name is cut to this many characters


def merged(intervals) -> List[List[float]]:
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    out: List[List[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


class StageRange:
    """Forwards a sequential round stage (and its ``prepare``) inside the
    profiler range ``stage.<key>``, which ends after a device synchronize
    so that every kernel the stage launched runs inside it.  The
    sequential pipeline synchronizes after every stage anyway."""

    def __init__(self, stage, key: str):
        self._stage, self._key = stage, key

    def __getattr__(self, attr):
        value = getattr(self._stage, attr)
        if attr == "prepare":
            return lambda ctx: self._ranged(value, ctx)
        return value

    def __call__(self, ctx):
        self._ranged(self._stage, ctx)

    def _ranged(self, fn, ctx):
        import torch

        with torch.profiler.record_function(f"stage.{self._key}"):
            fn(ctx)
            if torch.cuda.is_available():
                torch.cuda.synchronize()


@contextlib.contextmanager
def ranged_stages(pipeline):
    """Every stage of ``pipeline`` inside its ``StageRange`` for the
    duration of the block."""
    saved = {slot: getattr(pipeline, slot) for slot in STAGES}
    for slot, key in STAGES.items():
        setattr(pipeline, slot, StageRange(saved[slot], key))
    try:
        yield
    finally:
        for slot, stage in saved.items():
            setattr(pipeline, slot, stage)


@dataclass
class Trace:
    """What the benchmark takes from one profiled window of whole rounds."""

    window_s: float                       # wall time of the profiled rounds
    busy_s: float                         # union of device intervals
    device_s: Dict[str, float] = field(default_factory=dict)   # by name
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    def time_of(self, patterns) -> float:
        """Device seconds of every name holding one of the patterns."""
        return sum(s for name, s in self.device_s.items()
                   if any(p in name for p in patterns))

    def breakdown(self) -> dict:
        ops = sorted(self.device_s.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.gaps, key=lambda g: -g[1])[:TOP]
        return {"device_ops": [[name[:NAME_CHARS], s] for name, s in ops],
                "idle_gaps": [[name, s] for name, s in gaps]}


def profile_rounds(run_round, rounds: int, pipeline) -> Trace:
    """Runs ``rounds`` whole rounds under torch.profiler, every stage in its
    range, and reads the trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with ranged_stages(pipeline), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            with torch.profiler.record_function(ROUND_RANGE):
                run_round()
                torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device, host = [], []
    # the profiler's raw events: building its FunctionEvent tree would cost
    # more than the rounds
    for e in prof.profiler.kineto_results.events():
        item = (e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            device.append(item)
        elif e.device_type() == DeviceType.CPU and (
                item[0] == ROUND_RANGE or item[0].startswith("stage.")):
            host.append(item)
    return read_trace(device, host, wall)


def read_trace(device, host, wall_s: float) -> Trace:
    """``device``: (name, start us, end us) of every device event; ``host``:
    the round and stage ranges, the same.  Idle gaps are taken inside the
    round ranges, each named by the stage range around its middle."""
    busy = merged((lo, hi) for _, lo, hi in device)
    by_name: Dict[str, float] = {}
    for name, lo, hi in device:
        by_name[name] = by_name.get(name, 0.0) + (hi - lo) / 1e6
    rounds = merged((lo, hi) for name, lo, hi in host if name == ROUND_RANGE)
    stages = [(name[len("stage."):], lo, hi) for name, lo, hi in host
              if name.startswith("stage.")]
    gaps = []

    def gap(lo, hi):
        mid = (lo + hi) / 2
        where = next((s for s, a, b in stages if a <= mid <= b),
                     "between_stages")
        gaps.append((where, (hi - lo) / 1e6))

    for r_lo, r_hi in rounds:
        edge = r_lo
        for lo, hi in busy:
            if hi <= r_lo:
                continue
            if lo >= r_hi:
                break
            if lo > edge:
                gap(edge, lo)
            edge = max(edge, min(hi, r_hi))
        if r_hi > edge:
            gap(edge, r_hi)
    busy_in = sum(max(0.0, min(hi, r_hi) - max(lo, r_lo))
                  for lo, hi in busy for r_lo, r_hi in rounds) / 1e6
    return Trace(window_s=wall_s, busy_s=busy_in, device_s=by_name, gaps=gaps)
