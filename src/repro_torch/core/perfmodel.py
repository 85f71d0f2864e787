"""The paper's back-of-the-envelope performance models (§3.2–3.3).

Two regimes, exactly as in the paper:

* latency-bound (synchronous designs): throughput = 1 / Σ blocking I/O
  latency per transaction;
* cycle-bound (asynchronous designs): throughput = clock / (c_tx + r·c_io).

Benchmarks print the model prediction next to the simulated measurement —
the paper's own validation methodology (and our §Perf loop's napkin-math
step).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class LatencyModel:
    """Paper §3.3: synchronous designs are bound by device latency."""
    page_fault_rate: float
    read_lat_s: float = 70e-6
    write_lat_s: float = 12e-6
    batch_evict: bool = False          # batched writes leave read latency

    def tx_per_s(self) -> float:
        per_fault = self.read_lat_s + \
            (0.0 if self.batch_evict else self.write_lat_s)
        return 1.0 / (self.page_fault_rate * per_fault)


@dataclass
class CycleModel:
    """Paper §3.3.2: asynchronous designs are bound by CPU cycles."""
    c_tx: float                        # transaction logic cycles
    c_io: float                        # I/O submit+complete cycles/fault
    page_fault_rate: float
    clock_hz: float = 3.7e9

    def tx_per_s(self) -> float:
        return self.clock_hz / (self.c_tx +
                                self.page_fault_rate * self.c_io)


# Paper Table 1 cycle constants (3.7 GHz)
PAPER_C_TX = 8_264
PAPER_C_READ_SINGLE = 10_200
PAPER_C_READ_BATCH = 5_400
PAPER_C_WRITE_BATCH = 5_700
