"""Discrete-event timeline driving the simulated I/O world.

The paper measures on real NVMe arrays and 400G NICs; this container is
CPU-only, so device behaviour is modeled as events on a shared timeline
(latencies/bandwidths from the paper's Table 1 & §2) while *CPU* costs are
charged to the virtual clock explicitly. Everything is deterministic.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Callable, Optional

from dataclasses import dataclass

from repro_torch.core.clock import RealClock, VirtualClock


@dataclass
class CoreClock:
    """Busy-until clock of one simulated CPU core.

    The global ``Timeline`` carries *event* time (device completions,
    packet arrivals); a ``CoreClock`` carries the per-core CPU horizon so
    N cores can burn cycles concurrently without serializing on the
    global clock.  A ring constructed with ``core=`` charges CPU here
    instead of advancing the timeline; the multi-core ``FiberScheduler``
    resumes a fiber no earlier than its core's horizon.  Used by the
    shuffle engine (ring-per-worker) and, since the multi-core OLTP
    rungs, the storage engine (ring-per-core — see
    ``storage.engine.EngineConfig.multicore``)."""

    free: float = 0.0
    name: str = ""      # trace track label ("core3", "shuf-n0w2", ...)

    def charge(self, now: float, seconds: float) -> float:
        """Occupy the core for ``seconds`` starting no earlier than
        ``now``; returns the completion time."""
        t0 = max(now, self.free)
        self.free = t0 + seconds
        return self.free


class Timeline:
    def __init__(self, clock: Optional[VirtualClock] = None):
        self.clock = clock or VirtualClock()
        self._heap: list = []
        self._seq = itertools.count()

    @property
    def now(self) -> float:
        return self.clock.now()

    def at(self, t: float, fn: Callable[[], None]) -> None:
        heapq.heappush(self._heap, (t, next(self._seq), fn))

    def after(self, dt: float, fn: Callable[[], None]) -> None:
        self.at(self.now + dt, fn)

    def run_until(self, t: float) -> None:
        """Execute all events with timestamp <= t; clock ends at t."""
        while self._heap and self._heap[0][0] <= t:
            et, _, fn = heapq.heappop(self._heap)
            if et > self.clock.now():
                self.clock.advance_to(et)
            fn()
        if self.clock.now() < t:
            self.clock.advance_to(t)

    def run_next(self) -> bool:
        """Advance to and run the next pending event. False if none."""
        if not self._heap:
            return False
        et, _, fn = heapq.heappop(self._heap)
        if et > self.clock.now():
            self.clock.advance_to(et)
        fn()
        return True

    def pending(self) -> int:
        return len(self._heap)

    def peek(self) -> Optional[float]:
        """Timestamp of the next pending event, or None."""
        return self._heap[0][0] if self._heap else None
