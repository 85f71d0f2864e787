"""Deterministic, seeded fault-injection plane.

The simulated backends (``SimNVMe``/``SimDisk`` in ``core.backends``,
``SimSocket`` via the ring's send path) consult one shared
:class:`FaultPlane` on every operation.  The plane rolls a seeded RNG
against per-op-class probabilities — transient ``EIO`` on reads and
writes, short reads/writes (partial ``res``), fsync failures, NVMe
passthrough ``ENOTSUP``/timeouts, device latency spikes, socket resets
(``ECONNRESET``) and link flaps — optionally modulated by *scripted
fault windows* (absolute sim-time intervals with probability
overrides, e.g. a 100% write-failure window models a persistent device
error).

Determinism contract (pinned by tests/test_faults.py):

* one shared ``random.Random(seed)`` is consumed strictly in
  deterministic simulation event order, so the same seed and workload
  produce bit-identical fault sequences — and bit-identical
  ``RingStats`` and engine state;
* a roll whose *effective* probability is zero returns ``False``
  without consuming any RNG state, so a plane configured with all-zero
  rates is bit-identical to no plane at all (the ``bench_faults``
  zero-rate row must match the no-fault-plane baseline).

The plane only *decides* faults; the injection sites (backends and the
ring issue paths) apply them and bump the corresponding ``RingStats``
counters.  The plane additionally keeps its own per-class tally in
:attr:`FaultPlane.injected` for metrics/bench surfaces.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

__all__ = ["FaultSpec", "FaultPlane"]

#: op-class names the plane understands; anything else is a bug.
CLASSES = (
    "read_eio",        # READ* completes -EIO
    "write_eio",       # WRITE* completes -EIO (nothing persisted)
    "short_read",      # READ* completes with 0 < res < length
    "short_write",     # WRITE* completes with 0 < res < length
    "fsync_fail",      # FSYNC completes -EIO (page cache drops dirty data)
    "passthru_enotsup",  # uring-cmd completes -ENOTSUP
    "passthru_timeout",  # uring-cmd exceeds any linked timeout
    "latency_spike",   # device op takes spike_factor x longer
    "sock_reset",      # send completes -ECONNRESET, link flaps down
)


@dataclass(frozen=True)
class FaultSpec:
    """Per-op-class fault probabilities plus scripted windows.

    All probabilities are per *operation* (per SQE reaching the
    backend), independent rolls.  ``windows`` is a tuple of
    ``(t0, t1, overrides)`` entries: while ``t0 <= now < t1`` the
    override dict replaces the base probability for the named classes
    (e.g. ``(1e-3, 2e-3, {"write_eio": 1.0})`` is a persistent device
    failure lasting 1 ms).  Overlapping windows: the last matching
    window wins.
    """

    seed: int = 1
    read_eio: float = 0.0
    write_eio: float = 0.0
    short_read: float = 0.0
    short_write: float = 0.0
    fsync_fail: float = 0.0
    passthru_enotsup: float = 0.0
    passthru_timeout: float = 0.0
    latency_spike: float = 0.0
    #: multiplier applied to device latency on a latency_spike hit
    spike_factor: float = 8.0
    sock_reset: float = 0.0
    #: how long a socket stays down after a reset/flap (seconds);
    #: every send issued while down also fails with ECONNRESET
    flap_duration: float = 200e-6
    windows: Tuple[Tuple[float, float, dict], ...] = ()

    def any_nonzero(self) -> bool:
        if any(getattr(self, c) > 0.0 for c in CLASSES):
            return True
        return any(v > 0.0 for _, _, ov in self.windows
                   for v in ov.values())


@dataclass
class FaultPlane:
    spec: FaultSpec
    rng: random.Random = field(init=False)
    #: per-class injected-fault tally (what actually fired)
    injected: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self.rng = random.Random(self.spec.seed)
        for c in CLASSES:
            self.injected.setdefault(c, 0)

    # -- probability resolution -------------------------------------
    def rate(self, cls: str, now: float) -> float:
        assert cls in CLASSES, f"unknown fault class {cls!r}"
        p = getattr(self.spec, cls)
        for t0, t1, overrides in self.spec.windows:
            if t0 <= now < t1 and cls in overrides:
                p = overrides[cls]
        return p

    def roll(self, cls: str, now: float) -> bool:
        """One seeded roll against the effective probability.

        MUST be called in deterministic sim order.  Zero effective
        probability consumes no RNG state (bit-identical to no plane).
        """
        p = self.rate(cls, now)
        if p <= 0.0:
            return False
        hit = self.rng.random() < p
        if hit:
            self.injected[cls] += 1
        return hit

    def short_len(self, length: int) -> int:
        """Partial-completion length for a short read/write hit.

        Always in ``[1, length - 1]`` (a short I/O is nonzero but
        incomplete); single-byte ops can't be short, callers skip the
        roll for those.
        """
        assert length >= 2
        return 1 + self.rng.randrange(length - 1)

    # -- metrics ----------------------------------------------------
    @property
    def total_injected(self) -> int:
        return sum(self.injected.values())

    def register_metrics(self, reg, prefix: str = "faults") -> None:
        reg.counter(f"{prefix}/injected", lambda: self.total_injected)
        for c in CLASSES:
            reg.counter(f"{prefix}/injected/{c}",
                        lambda c=c: self.injected[c])


def maybe_plane(spec: Optional[FaultSpec]) -> Optional[FaultPlane]:
    """Build a plane only when the spec can ever fire.

    An all-zero spec returns ``None`` so the hot paths skip the fault
    hooks entirely — the zero-rate configuration is *structurally*
    identical to no fault plane, not just probabilistically.
    """
    if spec is None or not spec.any_nonzero():
        return None
    return FaultPlane(spec)
