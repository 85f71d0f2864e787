"""Group commit: batch concurrent fibers' commit points into one flush.

The first committer to find no flush in progress becomes the *leader*:
it flushes the log up to everything appended so far (one linked
write→fsync SQE chain in ``linked``/``passthru`` mode).  Every fiber
whose COMMIT record was already in the buffer rides along and is
released by the same fsync; fibers that arrive while the flush is in
flight suspend and are picked up by the next leader.  At 128 fibers
this amortizes the fsync far below one-per-txn (paper §3.4.2 / Fig. 9 —
the PostgreSQL WAL case study's 14% win comes from exactly this
batching plus the linked-chain submission).

Two commit-latency/group-size refinements ride on top:

* **Adaptive flush** (ROADMAP): with a ``policy`` (the ``AdaptiveFlush``
  shape from ``repro.core.adaptive``), the would-be leader defers the
  flush — bounded by ``MAX_DEFERS`` cooperative yields — while the
  engine's rings are busy and the group is still small, trading commit
  latency for fsync amortization exactly like the paper's adaptive
  submission batching trades enter()s for batch size.  ``signals()``
  supplies the (inflight, ready) pair from the scheduler.

* **Multi-core** (``MultiCoreGroupCommit``): with one ring per core
  there is no natural single flusher anymore, so durability gets the
  same treatment as submission — ONE dedicated leader fiber (pinned to
  a core by the engine) drains per-core commit queues and issues every
  flush on its own ring, keeping fsync submission SINGLE_ISSUER while
  commit points arrive from all cores.  Committers park on a ``Gate``
  (no ready-queue spinning) and are woken per flush.

``WalStats.groups`` records how many commits each flush released, so
benchmarks can report the achieved group size distribution.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, List, Optional, Tuple

from repro_torch.core.adaptive import SubmitPolicy
from repro_torch.core.fibers import FiberScheduler, Gate
from repro_torch.wal.log import WriteAheadLog

#: progress bound for adaptive deferral: a would-be leader yields at
#: most this many times before flushing regardless of the policy
MAX_DEFERS = 32


class GroupCommit:
    def __init__(self, wal: WriteAheadLog, *, mode: Optional[str] = None,
                 policy: Optional[SubmitPolicy] = None,
                 signals: Optional[Callable[[], Tuple[int, int]]] = None,
                 on_flush: Optional[Callable[[int, int], None]] = None):
        self.wal = wal
        self.mode = mode or wal.mode
        self.policy = policy              # None: flush eagerly (classic)
        self.signals = signals            # () -> (inflight, ready)
        if on_flush is not None:
            # log shipping taps the leader's flushed spans: every flush
            # this coordinator (or anyone else) completes reports
            # (prev_durable, new_durable) — see repro.replication
            wal.on_flush.append(on_flush)
        self._leading = False
        self._defers = 0
        self._waiting: List[int] = []     # commit LSN ends, not yet durable

    def commit(self, lsn: int, core: int = 0):
        """Fiber generator: suspend until the log is durable past
        ``lsn`` (the end offset of the caller's COMMIT record)."""
        w = self.wal
        if w.durable_lsn >= lsn:
            return
        self._waiting.append(lsn)
        while w.durable_lsn < lsn:
            if self._leading:
                yield None                 # follower: wait for the leader
                continue
            if self.policy is not None and self._defers < MAX_DEFERS:
                inflight, ready = self.signals() if self.signals else (0, 0)
                if not self.policy.should_flush(
                        queued=len(self._waiting), inflight=inflight,
                        ready=ready):
                    self._defers += 1      # device busy, group still
                    yield None             # small: let committers pile up
                    continue
            self._defers = 0
            self._leading = True
            try:
                yield from w.flush_to(w.end_lsn, mode=self.mode)
            finally:
                self._leading = False
            self._release()

    def _release(self) -> None:
        # fsyncgate audit: release is gated on ``durable_lsn``, which
        # ``WriteAheadLog._flush_once`` advances ONLY after an attempt
        # whose every write AND fsync succeeded (a failed fsync retries
        # with a full span re-write, or fail-stops).  A commit can
        # therefore never be acked off a failed barrier — the leader
        # finishing ``flush_to`` is not the release condition, the
        # durable horizon is.
        w = self.wal
        done = [l for l in self._waiting if l <= w.durable_lsn]
        if done:
            w.stats.groups.append(len(done))
            self._waiting = [l for l in self._waiting if l > w.durable_lsn]

    def queue_depth(self) -> int:
        """Committers enqueued but not yet released (telemetry gauge)."""
        return len(self._waiting)

    def register_metrics(self, reg, prefix: str) -> None:
        """Group-commit stat surface for the telemetry sampler: the
        commit-queue depth gauge plus windowed group size and commit
        wait derived from ``WalStats``.  Pure reads."""
        ws = self.wal.stats
        reg.gauge(f"{prefix}/commit_queue_depth", self.queue_depth)
        reg.counter(f"{prefix}/commits", lambda: ws.commits)
        reg.counter(f"{prefix}/fsyncs", lambda: ws.fsyncs)
        reg.wrate(f"{prefix}/group_size", lambda: sum(ws.groups),
                  lambda: len(ws.groups), unit="txn/flush")
        reg.wrate(f"{prefix}/commit_wait_us",
                  lambda: ws.commit_wait_s * 1e6,
                  lambda: ws.commits, unit="us")


class MultiCoreGroupCommit:
    """Cross-core commit queues feeding ONE leader fiber.

    ``commit`` (called from any core's worker fiber) enqueues the
    caller's commit LSN on its core's queue and parks on the release
    gate; the ``leader`` generator — spawned by the engine as a
    dedicated fiber — drains the queues, optionally defers under the
    adaptive policy, flushes on ITS ring, and opens the gate.  Workers
    re-check their LSN against ``durable_lsn`` and re-park if a later
    flush must cover them, so a spurious wakeup is harmless."""

    def __init__(self, wal: WriteAheadLog, *, n_cores: int,
                 sched: FiberScheduler, mode: Optional[str] = None,
                 policy: Optional[SubmitPolicy] = None,
                 signals: Optional[Callable[[], Tuple[int, int]]] = None,
                 on_flush: Optional[Callable[[int, int], None]] = None):
        self.wal = wal
        self.mode = mode or wal.mode
        if on_flush is not None:
            wal.on_flush.append(on_flush)     # see GroupCommit
        self.policy = policy
        self.signals = signals
        self.queues: List[deque] = [deque() for _ in range(n_cores)]
        self.pending = 0                  # enqueued, not yet released
        self._gate = Gate(sched)

    def commit(self, lsn: int, core: int = 0):
        """Fiber generator: enqueue on this core's commit queue and
        park until the leader's flush covers ``lsn``."""
        w = self.wal
        if w.durable_lsn >= lsn:
            return
        self.queues[core].append(lsn)
        self.pending += 1
        while w.durable_lsn < lsn:
            yield self._gate

    def leader(self, stop: Optional[Callable[[], bool]] = None):
        """The dedicated leader fiber.  Exits once ``stop()`` is true
        AND no commit is pending."""
        w = self.wal
        defers = 0
        while True:
            if self.pending == 0:
                if stop is not None and stop():
                    return
                yield None
                continue
            if self.policy is not None and defers < MAX_DEFERS:
                inflight, ready = self.signals() if self.signals else (0, 0)
                if not self.policy.should_flush(
                        queued=self.pending, inflight=inflight,
                        ready=ready):
                    defers += 1
                    yield None
                    continue
            defers = 0
            batch = 0                     # drain the cross-core queues
            for q in self.queues:
                batch += len(q)
                q.clear()
            yield from w.flush_to(w.end_lsn, mode=self.mode)
            w.stats.groups.append(batch)
            self.pending -= batch
            self._gate.open()

    def queue_depth(self) -> int:
        """Commits enqueued across all cores, not yet released."""
        return self.pending

    def register_metrics(self, reg, prefix: str) -> None:
        """Same surface as ``GroupCommit.register_metrics`` over the
        cross-core queues."""
        ws = self.wal.stats
        reg.gauge(f"{prefix}/commit_queue_depth", self.queue_depth)
        reg.counter(f"{prefix}/commits", lambda: ws.commits)
        reg.counter(f"{prefix}/fsyncs", lambda: ws.fsyncs)
        reg.wrate(f"{prefix}/group_size", lambda: sum(ws.groups),
                  lambda: len(ws.groups), unit="txn/flush")
        reg.wrate(f"{prefix}/commit_wait_us",
                  lambda: ws.commit_wait_s * 1e6,
                  lambda: ws.commits, unit="us")
