"""Opt-in ring/fiber event tracing with Chrome ``trace_event`` export.

The tracer is a passive observer: event sites in ``repro.core`` read
the module-global ``CURRENT`` and, when one is installed, append an
event tuple stamped with the *virtual* clocks that already exist —
``Timeline.now`` for kernel/event time, the per-``CoreClock`` horizon
for CPU-side events.  Nothing here charges cost or advances a clock,
so enabling tracing changes no virtual timestamp (observer effect =
zero; asserted in tests/test_observability.py).

Export is the Chrome trace-event JSON array format::

    {"traceEvents": [
      {"name": "sqe:read", "ph": "i", "ts": 12.3, "pid": 1001, "tid": 0,
       "s": "t", "args": {...}},
      {"name": "wal-leader", "ph": "X", "ts": 40.1, "dur": 3.2,
       "pid": 1, "tid": 0},
      {"name": "thread_name", "ph": "M", "pid": 1, "tid": 0,
       "args": {"name": "core0"}}, ...]}

``ts``/``dur`` are microseconds of virtual time.  Open the file at
https://ui.perfetto.dev (or chrome://tracing).  Track layout:

* pid ``FIBER_PID`` ("cores/fibers"): one thread per simulated core;
  each fiber resume is an "X" slice named after the fiber (WAL
  group-commit leader, shuffle sender/receiver workers, replication
  sender/standby fibers are spawned with explicit names);
* pid ``RING_PID_BASE + ring_id`` ("ringN"): kernel-side instants of
  that ring — enter, sqe:<opclass> submission, cqe reap, zc_notif,
  buf_ring_exhausted.

``benchmarks/run.py --trace out.json`` installs a tracer around the
selected bench modules and writes the export; use it with ``--smoke``
or ``--only`` — a full run emits tens of millions of events, so the
tracer caps itself at ``max_events`` and flags truncation.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

#: the installed tracer; event sites in repro.core read this directly
#: (module attribute, not a copy) so install/uninstall is instant
CURRENT: Optional["Tracer"] = None

FIBER_PID = 1           # one "process" holding a thread per core
RING_PID_BASE = 1000    # pid = RING_PID_BASE + IoUring.ring_id


class Tracer:
    """Append-only event buffer with Chrome trace-event export."""

    def __init__(self, max_events: int = 2_000_000):
        self.events: List[dict] = []
        self.max_events = max_events
        self.truncated = False
        self._meta: Dict[tuple, str] = {}   # (pid, tid) -> label

    # ------------------------------------------------------- event sites

    def instant(self, name: str, ts: float, pid: int, tid: int = 0,
                args: Optional[dict] = None) -> None:
        if len(self.events) >= self.max_events:
            self.truncated = True
            return
        ev = {"name": name, "ph": "i", "s": "t", "ts": ts * 1e6,
              "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def complete(self, name: str, ts: float, dur: float, pid: int,
                 tid: int = 0, args: Optional[dict] = None) -> None:
        if len(self.events) >= self.max_events:
            self.truncated = True
            return
        ev = {"name": name, "ph": "X", "ts": ts * 1e6,
              "dur": max(0.0, dur) * 1e6, "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)

    # ------------------------------------------------------- track labels

    def process_name(self, pid: int, name: str) -> None:
        if self._meta.get((pid, -1)) == name:
            return
        self._meta[(pid, -1)] = name
        self.events.append({"name": "process_name", "ph": "M", "pid": pid,
                            "tid": 0, "args": {"name": name}})

    def thread_name(self, pid: int, tid: int, name: str) -> None:
        if self._meta.get((pid, tid)) == name:
            return
        self._meta[(pid, tid)] = name
        self.events.append({"name": "thread_name", "ph": "M", "pid": pid,
                            "tid": tid, "args": {"name": name}})

    # ------------------------------------------------------- export

    def to_chrome(self) -> dict:
        return {"traceEvents": self.events,
                "displayTimeUnit": "ns",
                "otherData": {"truncated": self.truncated,
                              "n_events": len(self.events)}}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)


def install(tracer: Tracer) -> Tracer:
    """Make ``tracer`` the process-wide event sink."""
    global CURRENT
    CURRENT = tracer
    return tracer


def uninstall() -> None:
    global CURRENT
    CURRENT = None


def current() -> Optional[Tracer]:
    return CURRENT
