"""Request / slot bookkeeping for the continuous-batching engine.

The device side of serving is a fixed-capacity batch of ``num_slots``
request *slots* (one row of the batched KV cache + token/position vectors).
This module is the host-side mirror: which request occupies which slot, how
many tokens it still owes, and the per-request timing record the benchmark
aggregates.  All of it is plain numpy/python — the engine keeps device and
host state in sync at tick boundaries.

Port of ``repro/serve/slots.py`` (numpy and pure Python, copied as it is,
so the same trace gives the same slots and admissions; ``RequestResult``
also records the request's slot).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

FREE = -1


@dataclass
class Request:
    """One serving request: a prompt and a generation budget."""

    rid: int
    prompt: np.ndarray          # (S,) int32 token ids
    max_new: int                # tokens to generate (>= 1; the first comes
                                # from prefill itself)
    arrival: float = 0.0        # seconds since trace start

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])


@dataclass
class RequestResult:
    """Completed request: generated ids + the latency-metric timestamps."""

    rid: int
    prompt_len: int
    max_new: int
    tokens: List[int] = field(default_factory=list)
    arrival: float = 0.0
    admitted: float = -1.0      # entered a slot (prefill launched)
    first_token: float = -1.0   # first generated token observed
    finished: float = -1.0      # last generated token observed
    # params version (e.g. chain round) active when the request was admitted
    # and when it finished — differing values mean the request spanned a
    # hot-swap
    version_admitted: int = -1
    version_finished: int = -1
    # the decode-batch row the request occupied (-1: never held a slot);
    # the port's addition, so an oracle can decode it in the same row
    slot: int = -1

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.max_new

    @property
    def spans_swap(self) -> bool:
        return self.version_admitted != self.version_finished


class SlotTable:
    """Host mirror of the decode batch: per-slot request id + tokens owed."""

    def __init__(self, num_slots: int):
        if num_slots < 1:
            raise ValueError("need at least one slot")
        self.num_slots = num_slots
        self.rid = np.full((num_slots,), FREE, np.int64)
        self.remaining = np.zeros((num_slots,), np.int64)

    # ------------------------------------------------------------------
    def free_slots(self) -> List[int]:
        return [int(b) for b in np.nonzero(self.rid == FREE)[0]]

    @property
    def num_active(self) -> int:
        return int(np.sum(self.rid != FREE))

    @property
    def all_free(self) -> bool:
        return self.num_active == 0

    def occupy(self, b: int, rid: int, remaining: int) -> None:
        if self.rid[b] != FREE:
            raise RuntimeError(f"slot {b} already holds request {self.rid[b]}")
        self.rid[b] = rid
        self.remaining[b] = remaining

    def release(self, b: int) -> None:
        self.rid[b] = FREE
        self.remaining[b] = 0

    def active_snapshot(self) -> np.ndarray:
        """Slot -> rid copy, captured at tick launch (admissions between
        ticks re-assign slots, so the drain path must use the launch-time
        mapping, not the live table)."""
        return self.rid.copy()

    def decrement_active(self) -> List[int]:
        """One decode tick happened: every active slot owes one token fewer.
        Returns the slots that just produced their final token (freed by the
        caller after recording)."""
        done = []
        for b in range(self.num_slots):
            if self.rid[b] == FREE:
                continue
            self.remaining[b] -= 1
            if self.remaining[b] <= 0:
                done.append(b)
        return done
