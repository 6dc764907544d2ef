"""Spans and counters inside a BFLC round.

Every runtime holds a ``Recorder`` and makes it the active one for the
length of each round (``recording``).  The round's code marks its work
where it happens:

* ``stage(key, timings)`` is a round stage's own timing: the host seconds
  of the block go into ``timings[key]`` whether or not a recorder is
  active, and with one the block is also the span ``key``;
* ``span(name, device=False)`` adds its host seconds
  (``time.perf_counter_ns``) to the round's total of its name, under its
  parent span's name; with ``device=True`` on a CUDA runtime it also
  records a pair of timing events on the current stream, whose elapsed
  time (the span's device work and any idle time between its launches)
  is its ``device_s``.  No span waits for the device: the events are read
  once a round (``Recorder.entry``), after the round's last synchronize;
* ``count(name, n)`` adds ``n`` to one of the round's integer counters;
  ``note_live_bytes()`` keeps in the counter ``live_bytes`` the most
  device memory the allocator has held at its calls
  (``torch.cuda.memory_allocated``; 0 off CUDA).

While a torch profiler is active, a span also opens
``torch.profiler.record_function("bflc." + name)``, so the profiler's
trace holds the round's spans on the clock of the device's operations;
with none active no ``record_function`` is entered.  The ``bflc.`` prefix
keeps the mirrored names apart from the ``stage.*`` ranges a profiling
caller may put around the stages itself.

Outside a round, or inside ``recording(None)``, ``span`` and ``count`` do
nothing.  ``Recorder.entry`` turns the round's stage seconds into its
``stage_timings`` entry: the same dict of stage seconds, carrying the
round's ``spans`` (a ``SpanTotal`` by name) and ``counts`` as attributes.
"""
from __future__ import annotations

import time
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

PREFIX = "bflc."
ROOT = "round"                     # the parent of a span opened in no other

# the recorder of the round being run, if any (set by ``recording``)
_ACTIVE: ContextVar[Optional["Recorder"]] = ContextVar("repro_torch_spans",
                                                        default=None)


@dataclass
class SpanTotal:
    """A round's spans of one name, summed.  ``device_s`` (``device=True``
    spans on CUDA only) is the stream's elapsed time between each span's
    two events: device work and any idle time between its launches."""

    host_s: float = 0.0
    device_s: Optional[float] = None
    parents: Dict[str, float] = field(default_factory=dict)  # host s by parent


class RoundTimings(dict):
    """A round's ``stage_timings`` entry: the stage seconds by timing key,
    with the round's spans and counters as attributes."""

    def __init__(self, timings, spans: Dict[str, SpanTotal],
                 counts: Dict[str, int]):
        super().__init__(timings)
        self.spans = spans
        self.counts = counts


class Recorder:
    """The spans and counters of a runtime's current round.  Device events
    come from a pool and go back to it once read."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.device = torch.device(device)
        self._pool: List[torch.cuda.Event] = []
        self._begin()

    def _begin(self) -> None:
        self.totals: Dict[str, SpanTotal] = {}
        self.counts: Dict[str, int] = {}
        self.stack: List[str] = []
        self.pending = []                  # (total, start event, end event)

    def event(self) -> "torch.cuda.Event":
        if self._pool:
            return self._pool.pop()
        return torch.cuda.Event(enable_timing=True)

    def entry(self, timings) -> RoundTimings:
        """The round's ``stage_timings`` entry.  Every device event has
        passed: the round's last synchronize is behind."""
        for tot, start, end in self.pending:
            tot.device_s = (tot.device_s or 0.0) + start.elapsed_time(end) / 1e3
            self._pool += (start, end)
        entry = RoundTimings(timings, self.totals, self.counts)
        self._begin()
        return entry


class recording:
    """``with recording(recorder):`` makes ``recorder`` the active one for
    a round (``recorder=None``: nothing is recorded, not even into a
    recorder active around the block)."""

    def __init__(self, recorder: Optional[Recorder]):
        self.recorder = recorder

    def __enter__(self):
        if self.recorder is not None:
            self.recorder._begin()
        self.token = _ACTIVE.set(self.recorder)
        return self.recorder

    def __exit__(self, *exc):
        _ACTIVE.reset(self.token)
        return False


class _Span:
    __slots__ = ("rec", "name", "device", "timings", "parent", "mirror",
                 "events", "t0")

    def __init__(self, rec: Optional[Recorder], name: str, device: bool,
                 timings=None):
        self.rec, self.name, self.device, self.timings = \
            rec, name, device, timings

    def __enter__(self):
        rec = self.rec
        if rec is not None:
            self.parent = rec.stack[-1] if rec.stack else ROOT
            rec.stack.append(self.name)
            self.mirror = None
            if torch._C._autograd._profiler_enabled():
                self.mirror = torch.profiler.record_function(PREFIX + self.name)
                self.mirror.__enter__()
            self.events = None
            if self.device and rec.cuda:
                self.events = (rec.event(), rec.event())
                self.events[0].record(torch.cuda.current_stream(rec.device))
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter_ns()
        if self.timings is not None and exc_type is None:
            self.timings[self.name] = (self.timings.get(self.name, 0.0)
                                       + (t1 - self.t0) / 1e9)
        rec = self.rec
        if rec is None:
            return False
        rec.stack.pop()
        tot = rec.totals.get(self.name)
        if tot is None:
            tot = rec.totals[self.name] = SpanTotal()
        dt = (t1 - self.t0) / 1e9
        tot.host_s += dt
        tot.parents[self.parent] = tot.parents.get(self.parent, 0.0) + dt
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(rec.device))
            rec.pending.append((tot, *self.events))
        if self.mirror is not None:
            self.mirror.__exit__(exc_type, exc, tb)
        return False


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str, device: bool = False):
    """A span of the active round (nothing outside a recorded round)."""
    rec = _ACTIVE.get()
    return _NO_SPAN if rec is None else _Span(rec, name, device)


def stage(key: str, timings: Dict[str, float]):
    """A round stage: its host seconds added to ``timings[key]`` (unless
    the block raises), and the span ``key`` while a round is recorded."""
    return _Span(_ACTIVE.get(), key, False, timings)


def count(name: str, n: int) -> None:
    """Adds ``n`` to the active round's counter ``name``."""
    rec = _ACTIVE.get()
    if rec is not None:
        rec.counts[name] = rec.counts.get(name, 0) + int(n)


def note_live_bytes() -> None:
    """The round's counter ``live_bytes``: the most device memory the
    caching allocator held at any call, read from
    ``torch.cuda.memory_allocated`` (0 off CUDA).  The allocator's peak
    statistics are neither read nor reset."""
    rec = _ACTIVE.get()
    if rec is not None:
        held = torch.cuda.memory_allocated(rec.device) if rec.cuda else 0
        rec.counts["live_bytes"] = max(rec.counts.get("live_bytes", 0), held)
