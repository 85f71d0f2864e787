"""Cooperative fibers over the ring (paper §3.3.2 / §4.3).

Each transaction runs as a generator-based fiber that yields I/O requests
and is resumed when its completion arrives. Context switches are a Python
generator resume — the analogue of the paper's "tens of cycles" Boost
fiber switch; the simulated CPU charge is configurable.

A fiber may yield:
  * one ``IoRequest``       → resumed with its CQE,
  * a list of IoRequests    → resumed with the CQE list once ALL complete
    (this is how the buffer manager issues a batched eviction: N writes,
    one submission),
  * an ``IoRequest(multishot=True)`` → resumed immediately with the
    assigned user_data; subsequent CQEs of that op are consumed with
    ``StreamRead`` (multishot recv: one SQE, many CQEs),
  * ``StreamRead(ud)``      → resumed with the next CQE of stream ``ud``
    (parks until one arrives).  A CQE without ``CqeFlags.MORE`` ends the
    stream.  SEND_ZC's deferred ``ZC_NOTIF`` is reaped the same way:
    the send's first CQE carries ``MORE`` and auto-opens a stream,
  * ``StreamClose(ud)``     → cancel a still-armed multishot op,
  * a ``Gate``              → park until another fiber opens the gate
    (condition wait without ready-queue spinning),
  * ``None``                → cooperative yield (re-queued).

Because all concurrency is cooperative, data structures need no locks
(paper: the B-tree restarts traversal if the world changed across a
suspension point — see storage/btree.py).

Scheduling modes
================

*Single-core* (default, the storage engine): one ring, one virtual CPU;
CPU charges advance the global timeline directly — exactly the paper's
one-core buffer-manager experiments.

*Multi-core* (the shuffle engine): pass ``rings=[...]`` (one per worker,
each constructed with a ``CoreClock``) and ``cores=[...]``.  Fibers are
pinned to a (core, ring) pair at ``spawn``.  The scheduler is a
conservative discrete-event loop: it always resumes the runnable fiber
whose core becomes free earliest, first draining any timeline events
(completions, packet arrivals) that precede that point, so N cores burn
CPU concurrently while sharing one deterministic timeline.
"""

from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, Generator, List, Optional

from repro_torch.core.adaptive import AdaptiveBatcher, SubmitPolicy
from repro_torch.core.ring import IoUring
from repro_torch.core.sqe import CQE, SQE, CqeFlags
from repro_torch.core.timeline import CoreClock
from repro_torch.observe import metrics as _metrics
from repro_torch.observe import trace as _trace


@dataclass
class IoRequest:
    """What a fiber yields: a prepared-SQE builder. The scheduler assigns
    user_data and decides when the batch enters the kernel."""
    prep: Callable[[SQE, int], None]      # (sqe, user_data) -> None
    multishot: bool = False               # one SQE -> many CQEs (stream)


@dataclass
class StreamRead:
    """Yield to consume the next CQE of a multishot stream (or a
    SEND_ZC notification)."""
    ud: int


@dataclass
class StreamClose:
    """Yield to cancel a still-armed multishot op and drop its stream."""
    ud: int


class Gate:
    """Parking lot for condition waits: ``yield gate`` suspends the
    calling fiber until another fiber calls ``gate.open()`` (which wakes
    every parked fiber; each re-checks its condition and may re-park).

    Spinning on ``yield None`` keeps a fiber in the ready queue, so a
    hundred commit waiters would burn a scheduler resume each per step;
    parked fibers cost nothing until the gate opens.  Always ``open()``
    any gate another fiber may be parked on BEFORE parking yourself —
    parked fibers are invisible to the scheduler's termination check."""

    __slots__ = ("_sched", "_parked")

    def __init__(self, sched: "FiberScheduler"):
        self._sched = sched
        self._parked: List[Fiber] = []

    def open(self) -> int:
        """Wake every parked fiber; returns how many were woken."""
        n = len(self._parked)
        if n:
            self._sched.ready.extend((f, None) for f in self._parked)
            self._parked.clear()
        return n


class _Stream:
    __slots__ = ("q", "waiter", "done", "owner")

    def __init__(self, owner: "Fiber"):
        self.q: deque = deque()
        self.waiter: Optional["Fiber"] = None
        self.done = False
        self.owner = owner


class Fiber:
    _ids = itertools.count(1)

    def __init__(self, gen: Generator, *, core: int = 0, ring: int = 0,
                 name: str = ""):
        self.id = next(Fiber._ids)
        self.gen = gen
        self.core = core                  # CoreClock index (multi-core)
        self.ring_idx = ring              # ring index (ring-per-worker)
        self.name = name                  # trace track label (optional)
        self.done = False
        self.value: Any = None            # generator return value
        self._pending = 0
        self._results: List[CQE] = []
        self._group = False

    def __repr__(self):
        label = f" {self.name}" if self.name else ""
        return f"<Fiber {self.id}{label}{' done' if self.done else ''}>"


class FiberScheduler:
    """Round-robin ready queue + completion-driven wakeups.

    The submit policy decides when queued SQEs enter the kernel —
    ``AdaptiveBatcher`` implements the paper's adaptive batching (§3.3.3):
    flush early when few I/Os are in flight (keep the device busy), defer
    when many are (amortize the syscall).  ``per_op_submit`` instead
    enters the kernel once per SQE — the epoll-style one-syscall-per-I/O
    baseline of the shuffle study (Fig. 13).
    """

    def __init__(self, ring: Optional[IoUring] = None, *,
                 rings: Optional[List[IoUring]] = None,
                 cores: Optional[List[CoreClock]] = None,
                 policy: Optional[SubmitPolicy] = None,
                 policies: Optional[List[SubmitPolicy]] = None,
                 switch_cost_s: float = 20 / 3.7e9,
                 per_op_submit: bool = False):
        self.rings = rings if rings is not None else [ring]
        assert self.rings and self.rings[0] is not None
        self.ring = self.rings[0]         # single-core alias
        self.cores = cores
        self.mc = cores is not None
        self.policy = policy or AdaptiveBatcher()
        # optional per-ring policies (ring-per-core: each core batches
        # its own submissions independently); fall back to the shared
        # policy object when absent
        self.policies = policies
        self.per_op_submit = per_op_submit
        self.ready: deque = deque()
        # multi-core: arrivals are staged into per-core FIFOs stamped
        # with a global arrival sequence, so the O(cores) pick below is
        # order-equivalent to scanning one global ready list
        self._core_ready: Optional[List[deque]] = \
            [deque() for _ in cores] if self.mc else None
        self._rseq = itertools.count()
        self.waiting: Dict[int, Fiber] = {}
        self.streams: Dict[int, _Stream] = {}
        self._orphans: set = set()        # closed streams whose terminal
                                          # CQE is still in flight
        self.switch_cost_s = switch_cost_s
        self.inflight = 0
        self._queued = 0                  # SQEs prepared but not submitted
        self._ring_queued = [0] * len(self.rings)
        self._uds = itertools.count(1)
        self.completed_fibers = 0
        # hook: called with the fiber about to be resumed (the storage
        # engine uses it to track the current core for CPU/latch charges)
        self.on_resume: Optional[Callable[[Fiber], None]] = None

    # ------------------------------------------------------------------

    def spawn(self, gen: Generator, *, core: int = 0,
              ring: int = 0, name: str = "") -> Fiber:
        f = Fiber(gen, core=core, ring=ring, name=name)
        self.ready.append((f, None))
        return f

    def attach_ring(self, ring: IoUring, *,
                    core: Optional[CoreClock] = None,
                    policy: Optional[SubmitPolicy] = None) -> int:
        """Adopt another node's ring into this scheduler (replication:
        the standby's ring joins the primary's scheduler so one
        deterministic event loop drives both ends of the wire).
        Returns the ring index to ``spawn`` fibers on.  In multi-core
        mode a ``core`` is required and the returned index is also the
        fiber's core index; in single-core mode the ring's own
        ``CoreClock`` (if any) merely accumulates that node's CPU."""
        self.rings.append(ring)
        self._ring_queued.append(0)
        if self.mc:
            assert core is not None, "multi-core attach needs a CoreClock"
            self.cores.append(core)
            self._core_ready.append(deque())
            if self.policies is not None:
                self.policies.append(policy or AdaptiveBatcher())
        return len(self.rings) - 1

    def ready_count(self) -> int:
        """Runnable fibers (staged per-core FIFOs included)."""
        n = len(self.ready)
        if self._core_ready is not None:
            n += sum(len(q) for q in self._core_ready)
        return n

    def run(self, *, until: Optional[Callable[[], bool]] = None) -> None:
        """Run until all fibers finish (or ``until`` returns True)."""
        while True:
            # opt-in telemetry hook: sample the installed registry at
            # its virtual-time cadence.  Deliberately NOT a fiber — a
            # queued sampler would perturb ready_count(), which the
            # adaptive submit/flush policies read; this hook only reads
            # clocks and counters (observer effect = zero, pinned in
            # tests/test_observability.py)
            mreg = _metrics.CURRENT
            if mreg is not None:
                mreg.maybe_sample(self.ring.tl.now)
            if until is not None and until():
                return
            if self.ready_count() == 0 and not self.waiting \
                    and not self.streams and self._queued == 0:
                return
            if self.mc:
                self._step_mc()
            else:
                self._step()

    # ------------------------------------------------- single-core step

    _spins = 0

    def _step(self) -> None:
        if self.ready:
            # livelock guard: if every ready fiber is just spinning on a
            # condition (bare yields) while I/O is in flight, make progress
            # on the timeline instead of burning the ready queue.
            if self._spins > len(self.ready) + 1 and self.inflight:
                self._flush()              # may drain everything
                if not any(r.cq for r in self.rings) and self.inflight:
                    # with attached rings an empty timeline is not a
                    # deadlock here — armed multishot streams keep
                    # ``inflight`` high while a runnable fiber (a flush
                    # leader holding its CQEs) is what will progress;
                    # on the historical 1-ring path it IS one, so keep
                    # raising there rather than spinning silently
                    self._wait_dispatch(require=len(self.rings) == 1)
                self._spins = 0
            fiber, send_val = self.ready.popleft()
            before = len(self.ready)
            self._resume(fiber, send_val)
            if self.ready and len(self.ready) > before and \
                    self.ready[-1][0] is fiber and self.ready[-1][1] is None:
                self._spins += 1
            else:
                self._spins = 0
            if self._queued and self.policy.should_flush(
                    queued=self._queued, inflight=self.inflight,
                    ready=len(self.ready)):
                self._flush()
            return
        # no ready fibers: everything is waiting on I/O -> flush + wait
        if self._queued:
            self._flush()
        if self.inflight:
            self._wait_dispatch()

    # -------------------------------------------------- multi-core step

    def _step_mc(self) -> None:
        tl = self.ring.tl
        cr = self._core_ready
        while self.ready:                 # stage arrivals per core; the
            f, v = self.ready.popleft()   # seq stamp preserves the global
            cr[f.core].append((next(self._rseq), f, v))   # FIFO order
        best_c, best_t, best_s = -1, float("inf"), float("inf")
        for c, q in enumerate(cr):
            if not q:
                continue
            # conservative PDES: resume the fiber whose core frees
            # earliest; ties resolve to the earliest-queued fiber, which
            # is exactly the order a single global ready-list scan gives
            t = max(tl.now, self.cores[c].free)
            if t < best_t or (t == best_t and q[0][0] < best_s):
                best_c, best_t, best_s = c, t, q[0][0]
        if best_c >= 0:
            if self._spins > self.ready_count() + 1:
                # every runnable fiber is polling a condition (bare
                # yields) — progress needs the world to move: submit any
                # queued SQEs and fire the next timeline event, exactly
                # like the single-core livelock guard
                self._spins = 0
                self._flush_all()
                self._drain_all()
                if not self.ready and tl.peek() is not None:
                    tl.run_next()
                    self._drain_all()
                return
            nxt = tl.peek()
            if nxt is not None and nxt < best_t:
                tl.run_next()             # an earlier event may ready an
                self._drain_all()         # even earlier fiber
                return
            _, fiber, send_val = cr[best_c].popleft()
            if best_t > tl.now:
                tl.run_until(best_t)      # no earlier events: just advance
            before = len(self.ready)
            self._resume(fiber, send_val)
            if self.ready and len(self.ready) > before and \
                    self.ready[-1][0] is fiber and self.ready[-1][1] is None:
                self._spins += 1
            else:
                self._spins = 0
            i = fiber.ring_idx
            pol = self.policies[i] if self.policies else self.policy
            if self._ring_queued[i] and pol.should_flush(
                    queued=self._ring_queued[i], inflight=self.inflight,
                    ready=self.ready_count()):
                self._flush_ring(i)
            self._drain_all()
            return
        # nothing runnable: flush every ring, then advance the world
        self._flush_all()
        self._drain_all()
        if self.ready:
            return
        if self.inflight or self.streams:
            if not tl.run_next():
                raise RuntimeError(
                    "deadlock: fibers waiting with an empty timeline")
            self._drain_all()

    # ------------------------------------------------------------------

    def _fiber_clock(self, fiber: Fiber) -> float:
        """The resumed fiber's CPU clock — its core horizon in
        multi-core mode, the global clock otherwise.  Trace-only."""
        if self.mc:
            return max(self.ring.tl.now, self.cores[fiber.core].free)
        return self.ring.tl.now

    def _trace_slice(self, tr, fiber: Fiber, t0: float,
                     mark: str = "") -> None:
        """One "X" slice on the fiber's core track covering this resume
        (pure clock reads: tracing charges nothing — observer effect is
        zero, asserted in tests)."""
        t1 = self._fiber_clock(fiber)
        core = self.cores[fiber.core] if self.mc else None
        label = core.name if (core is not None and core.name) \
            else f"core{fiber.core}"
        tr.process_name(_trace.FIBER_PID, "cores/fibers")
        tr.thread_name(_trace.FIBER_PID, fiber.core, label)
        tr.complete(fiber.name or f"fiber{fiber.id}", t0, t1 - t0,
                    _trace.FIBER_PID, fiber.core)
        if mark:
            tr.instant(mark, t1, _trace.FIBER_PID, fiber.core,
                       {"fiber": fiber.name or fiber.id})

    def _resume(self, fiber: Fiber, send_val) -> None:
        if self.mc:
            # a shared (contended) ring is submitted to by many cores:
            # point its CPU accounting at the fiber about to run.  With
            # ring-per-core this is the identity assignment.
            ring = self.rings[fiber.ring_idx]
            if ring.core is not None:
                ring.core = self.cores[fiber.core]
        if self.on_resume is not None:
            self.on_resume(fiber)
        tr = _trace.CURRENT
        t0 = self._fiber_clock(fiber) if tr is not None else 0.0
        if self.switch_cost_s:
            if self.mc:
                self.cores[fiber.core].charge(self.ring.tl.now,
                                              self.switch_cost_s)
            else:
                self.ring.tl.run_until(self.ring.tl.now +
                                       self.switch_cost_s)
        try:
            req = fiber.gen.send(send_val)
        except StopIteration as stop:
            fiber.done = True
            fiber.value = stop.value
            self.completed_fibers += 1
            if tr is not None:
                self._trace_slice(tr, fiber, t0, mark="fiber-done")
            self._reap_abandoned_streams(fiber)
            return
        if tr is not None:
            self._trace_slice(
                tr, fiber, t0,
                mark="fiber-park" if isinstance(req, Gate) else "")
        if req is None:                   # cooperative re-queue
            self.ready.append((fiber, None))
            return
        if isinstance(req, Gate):         # park until gate.open()
            req._parked.append(fiber)
            return
        if isinstance(req, StreamRead):
            self._stream_read(fiber, req.ud)
            return
        if isinstance(req, StreamClose):
            self._stream_close(fiber, req.ud)
            return
        ring = self.rings[fiber.ring_idx]
        if isinstance(req, IoRequest) and req.multishot:
            ud = self._enqueue(ring, fiber.ring_idx, req)
            self.streams[ud] = _Stream(fiber)
            self.inflight += 1
            self.ready.append((fiber, ud))   # hand the stream id back
            return
        reqs = req if isinstance(req, list) else [req]
        fiber._group = isinstance(req, list)
        fiber._pending = len(reqs)
        fiber._results = []
        for r in reqs:
            if not isinstance(r, IoRequest):
                raise TypeError(f"fiber yielded {type(r)}")
            ud = self._enqueue(ring, fiber.ring_idx, r)
            self.waiting[ud] = fiber
            self.inflight += 1

    def _enqueue(self, ring: IoUring, ring_idx: int, r: IoRequest) -> int:
        sqe = ring.get_sqe()
        while sqe is None:            # SQ full: flush and retry
            self._flush_ring(ring_idx)
            sqe = ring.get_sqe()
        ud = next(self._uds)
        r.prep(sqe, ud)
        sqe.user_data = ud
        if self.per_op_submit:        # epoll baseline: 1 enter per I/O
            ring.submit()
        else:
            self._queued += 1
            self._ring_queued[ring_idx] += 1
        return ud

    # ------------------------------------------------------- streams

    def _stream_read(self, fiber: Fiber, ud: int) -> None:
        st = self.streams.get(ud)
        if st is None:
            raise RuntimeError(f"StreamRead on unknown/closed stream {ud}")
        if st.q:
            cqe = st.q.popleft()
            if st.done and not st.q:
                del self.streams[ud]
            self.ready.append((fiber, cqe))
            return
        if st.done:                   # terminal CQE already consumed
            raise RuntimeError(f"StreamRead past end of stream {ud}")
        st.waiter = fiber

    def _drop_stream(self, ud: int, st: _Stream) -> None:
        """Close one stream's accounting: cancel a still-armed multishot
        recv, or — when cancel() finds nothing to disarm (a SEND_ZC
        notification stream: its terminal ZC_NOTIF CQE is already in
        flight) — leave a tombstone so _dispatch settles the inflight
        count when that CQE lands."""
        if st.done:
            return
        if self.rings[st.owner.ring_idx].cancel(ud):
            self.inflight -= 1
        else:
            self._orphans.add(ud)
        st.done = True

    def _stream_close(self, fiber: Fiber, ud: int) -> None:
        st = self.streams.pop(ud, None)
        if st is not None:
            self._drop_stream(ud, st)
        self.ready.append((fiber, None))

    def _reap_abandoned_streams(self, fiber: Fiber) -> None:
        """A finished fiber's streams can never be read again: cancel
        still-armed ops so ``run()`` can terminate."""
        for ud, st in list(self.streams.items()):
            if st.owner is fiber:
                self._drop_stream(ud, st)
                del self.streams[ud]

    # ------------------------------------------------------- flushing

    def _flush(self) -> None:
        if len(self.rings) == 1:      # single-core mode lives on ring 0
            self._flush_ring(0)
            self._drain_some()
        else:                         # attached rings (replication):
            self._flush_all()         # flush + reap every node's ring
            self._drain_all()

    def _wait_dispatch(self, *, require: bool = True) -> None:
        """Block until a completion arrives on ANY ring; dispatch it.
        With one ring this is exactly ``wait_cqe`` (the historical
        single-core path); with attached rings the scheduler is the
        wait side for all of them.  ``require=False``: an exhausted
        timeline is acceptable (the caller has runnable fibers)."""
        if len(self.rings) == 1 and require:
            self._dispatch(self.ring.wait_cqe())
            return
        tl = self.ring.tl
        while True:
            for ring in self.rings:
                ring._run_task_work()
                cqe = ring.peek_cqe()
                if cqe is not None:
                    self._dispatch(cqe)
                    return
            if not tl.run_next():
                if require:
                    raise RuntimeError(
                        "deadlock: fibers waiting with an empty timeline")
                return

    def _flush_ring(self, i: int) -> None:
        if self._ring_queued[i]:
            self.rings[i].submit()
            self._queued -= self._ring_queued[i]
            self._ring_queued[i] = 0

    def _flush_all(self) -> None:
        for i in range(len(self.rings)):
            self._flush_ring(i)

    def _drain_some(self) -> None:
        while True:
            cqe = self.ring.peek_cqe()
            if cqe is None:
                return
            self._dispatch(cqe)

    def _drain_all(self) -> None:
        for ring in self.rings:
            # DeferTaskrun reaps completions inside enter/wait; the
            # scheduler's drain IS the wait side in multi-core mode
            ring._run_task_work()
            while True:
                cqe = ring.peek_cqe()
                if cqe is None:
                    break
                self._dispatch(cqe)

    # ------------------------------------------------------- dispatch

    def _dispatch(self, cqe: CQE) -> None:
        ud = cqe.user_data
        st = self.streams.get(ud)
        if st is not None:
            if not (cqe.flags & CqeFlags.MORE):
                st.done = True
                self.inflight -= 1
            if st.waiter is not None:
                f, st.waiter = st.waiter, None
                if st.done and not st.q:
                    del self.streams[ud]
                self.ready.append((f, cqe))
            else:
                st.q.append(cqe)
            return
        fiber = self.waiting.get(ud)
        if fiber is None:
            if ud in self._orphans and not (cqe.flags & CqeFlags.MORE):
                # terminal CQE of a closed/abandoned stream (e.g. an
                # unreaped ZC_NOTIF): settle the inflight count
                self._orphans.discard(ud)
                self.inflight -= 1
            return                        # canceled / already closed
        if cqe.flags & CqeFlags.MORE:
            # e.g. SEND_ZC: first CQE completes the request but the
            # buffer-release ZC_NOTIF is still outstanding — auto-open a
            # stream so the fiber can reap it with StreamRead(ud)
            del self.waiting[ud]
            self.streams[ud] = _Stream(fiber)
        else:
            del self.waiting[ud]
            self.inflight -= 1
        fiber._pending -= 1
        fiber._results.append(cqe)
        if fiber._pending == 0:
            val = fiber._results if fiber._group else fiber._results[0]
            self.ready.append((fiber, val))
