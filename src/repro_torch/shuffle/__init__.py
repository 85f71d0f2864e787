"""Distributed data shuffle (paper §4) — engine and oracle.

Two implementations of the same shuffle, deliberately kept in lockstep:

``shuffle.engine`` (ShuffleEngine)
    The REAL one: morsel-driven worker fibers on a multi-core
    ``FiberScheduler`` (ring-per-worker, ``CoreClock`` per core), moving
    every byte through SEND/SEND_ZC/RECV SQEs over ``SimSocket``
    endpoints — multishot recv backed by provided buffer rings, deferred
    ZC_NOTIF buffer release, measured ``RingStats.enters`` syscall
    counts, and an epoll baseline (one enter per I/O).  This is the same
    ring runtime the §3 storage engine runs on: Fig. 11-16 and Fig. 5-9
    are now emergent properties of one substrate.

``shuffle.sim`` (ShuffleSim)
    The analytical ORACLE: identical data movement (``shuffle.plan``)
    and identical link pacing (``SimNetwork.flow_schedule``), but each
    step's CPU charged in closed form.  It cross-validates the engine —
    egress agreement within 20% at 512 B / 4 KiB tuples is asserted in
    tests/test_shuffle.py — and scans large parameter grids cheaply in
    benchmarks/bench_shuffle.py.

``shuffle.plan``
    The shared morsel/chunk plan: pure function of the config, so any
    egress disagreement between the two is a timing-model delta, never
    a data-movement bug.

Known modeling gap: under extreme receive fan-in (6 nodes x 32 workers,
probe-bound tuples) the closed form underestimates rx-side queueing
feedback by ~25-35%; the bench's cross-validation section reports the
delta per config.
"""

from repro_torch.shuffle.engine import ShuffleEngine
from repro_torch.shuffle.plan import (expected_flow_bytes, morsel_plan,
                                      receiver_worker)
from repro_torch.shuffle.sim import ShuffleConfig, ShuffleSim

__all__ = ["ShuffleConfig", "ShuffleEngine", "ShuffleSim",
           "expected_flow_bytes", "morsel_plan", "receiver_worker"]
