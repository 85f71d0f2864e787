"""Clocks for the host I/O runtime.

The paper measures everything on real hardware.  This container is CPU-only,
so the runtime supports two interchangeable clocks:

* :class:`RealClock` — wall time.  Used when the backend performs *real* I/O
  (``FileBackend``) inside the training framework.
* :class:`VirtualClock` — a discrete-event simulation clock.  Used with the
  simulated NVMe/NIC backends so the paper's experiments (Fig. 5, Table 2,
  Fig. 11/16 …) reproduce deterministically: device latencies are modeled,
  CPU costs are *charged* to the clock explicitly (either from the paper's
  measured constants or from real ``perf_counter`` deltas of the actual
  Python work, scaled by a calibration factor).
"""

from __future__ import annotations

import time


class RealClock:
    """Wall-clock time; waiting really sleeps."""

    virtual = False

    def now(self) -> float:
        return time.perf_counter()

    def advance(self, dt: float) -> None:  # CPU charge: real time already passed
        pass

    def advance_to(self, t: float) -> None:
        while True:
            dt = t - time.perf_counter()
            if dt <= 0:
                return
            time.sleep(min(dt, 0.0005))


class VirtualClock:
    """Deterministic discrete-event clock.

    ``advance`` models CPU work consumed on the application core;
    ``advance_to`` models idle waiting (e.g. blocked on the CQ).
    """

    virtual = True

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"negative clock charge: {dt}")
        self._now += dt

    def advance_to(self, t: float) -> None:
        if t > self._now:
            self._now = t


class CpuTimer:
    """Measures *real* CPU time of a code block and charges it to a virtual
    clock, scaled by ``1/scale``.

    The paper's transaction logic costs ~8 264 cycles (~2.2 µs at 3.7 GHz);
    the same logic in CPython is ~50–100× slower.  ``scale`` calibrates the
    measured Python time back to the paper's native-code regime so that the
    CPU-vs-I/O balance of the simulation matches the paper's system.  The
    calibration constant is reported alongside every benchmark result.
    """

    def __init__(self, clock, scale: float = 1.0):
        self.clock = clock
        self.scale = scale
        self.total_charged = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = (time.perf_counter() - self._t0) / self.scale
        self.total_charged += dt
        self.clock.advance(dt)
        return False
