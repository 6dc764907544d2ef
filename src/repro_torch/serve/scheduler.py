"""Admission scheduling: which queued requests enter which free slots.

Two policies over one FIFO arrival queue:

* ``continuous`` — in-flight batching: any free slot is filled as soon as an
  arrived request is waiting.  Finished slots free at tick boundaries, so a
  short request never waits for a long one to drain.
* ``static``     — the legacy static-batch discipline (the baseline the
  benchmark compares against): requests are only admitted when *every* slot
  is free, i.e. the whole batch starts together and the next batch waits for
  the slowest request of the current one.

Both see the same arrival trace and the same engine; the measured gap is
purely the admission policy.

Port of ``repro/serve/scheduler.py`` (pure Python, copied as it is).
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Iterable, List, Optional, Tuple

from repro_torch.serve.slots import Request, SlotTable

POLICIES = ("continuous", "static")


class FifoScheduler:
    def __init__(self, requests: Iterable[Request], policy: str = "continuous"):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; known: {POLICIES}")
        self.policy = policy
        # arrival order; the trace generator emits sorted arrivals
        self._future: Deque[Request] = deque(
            sorted(requests, key=lambda r: (r.arrival, r.rid))
        )
        self._queue: Deque[Request] = deque()

    # ------------------------------------------------------------------
    def ingest(self, now: float) -> None:
        """Move requests whose arrival time has passed into the ready queue."""
        while self._future and self._future[0].arrival <= now:
            self._queue.append(self._future.popleft())

    @property
    def queued(self) -> int:
        return len(self._queue)

    @property
    def exhausted(self) -> bool:
        """No request is waiting now and none will ever arrive."""
        return not self._future and not self._queue

    def next_arrival(self) -> Optional[float]:
        return self._future[0].arrival if self._future else None

    # ------------------------------------------------------------------
    def admissions(self, table: SlotTable, now: float) -> List[Tuple[int, Request]]:
        """(slot, request) pairs to admit at this tick boundary."""
        self.ingest(now)
        if not self._queue:
            return []
        if self.policy == "static" and not table.all_free:
            # batch barrier: the whole cohort drains before the next starts
            return []
        out: List[Tuple[int, Request]] = []
        for b in table.free_slots():
            if not self._queue:
                break
            out.append((b, self._queue.popleft()))
        return out
