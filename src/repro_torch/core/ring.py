"""The io_uring ring, adapted: SQ/CQ over a discrete-event kernel model.

API mirrors liburing so the mapping to the paper is one-to-one:

    ring = IoUring(timeline, sq_depth=256,
                   setup=SetupFlags.DEFER_TASKRUN | SetupFlags.SINGLE_ISSUER)
    ring.register_device(fd, SimNVMe(timeline))
    sqe = ring.get_sqe()
    prep_read(sqe, fd, buf, offset, length, user_data=...)
    ring.submit()                      # one "enter" for the whole batch
    cqe = ring.wait_cqe()

Execution paths (paper Fig. 3): inline completion, poll-set async
completion, io_worker fallback — each charged with the CostModel and
tagged in the CQE flags so benchmarks can attribute cycles.
"""

from __future__ import annotations

import itertools
from collections import deque
from typing import Dict, List, Optional

from repro_torch.core.backends import FileBackend, SimNVMe, SimSocket
from repro_torch.core.costs import DEFAULT_COSTS, CostModel
from repro_torch.core.sqe import (CQE, EAGAIN, ECANCELED, ECONNRESET, EINVAL,
                            EIO, ENOTSUP, ETIME, SQE, CqeFlags, Op,
                            RingStats, SetupFlags, SqeFlags, op_class)
from repro_torch.core.timeline import CoreClock, Timeline
# passive event sink (repro.observe.trace.CURRENT); imports nothing
# back from repro.core, and costs nothing when no tracer is installed
from repro_torch.observe import trace as _trace


class RegisteredBuffers:
    """Pre-registered (pinned) buffer table — paper §3.4.1 RegBufs."""

    def __init__(self, buffers: List[bytearray]):
        self.buffers = [memoryview(b) for b in buffers]

    def __getitem__(self, i: int) -> memoryview:
        return self.buffers[i]

    def __len__(self):
        return len(self.buffers)


class BufferRing:
    """Provided buffer ring (``io_uring_register_buf_ring``, paper §4.2).

    The application hands the kernel a ring of equally-sized buffers;
    each recv completion consumes one slot (``CQE.buf_id``) and the app
    recycles it after processing.  An empty ring terminates the recv —
    multishot included — with ``EAGAIN`` and no ``MORE`` flag, so the
    consumer must recycle buffers and re-arm."""

    def __init__(self, bgid: int, buffers: List[bytearray]):
        self.bgid = bgid
        self.buffers = [memoryview(b) for b in buffers]
        self.free: deque = deque(range(len(buffers)))

    def get(self) -> Optional[int]:
        return self.free.popleft() if self.free else None

    def recycle(self, bid: int) -> None:
        self.free.append(bid)

    def available(self) -> int:
        return len(self.free)


class IoUring:
    _ring_ids = itertools.count()

    def __init__(self, timeline: Timeline, *, sq_depth: int = 256,
                 cq_depth: int = 0, setup: SetupFlags = SetupFlags.NONE,
                 costs: CostModel = DEFAULT_COSTS, n_workers: int = 32,
                 core: Optional[CoreClock] = None,
                 contended: bool = False):
        self.tl = timeline
        self.sq_depth = sq_depth
        self.cq_depth = cq_depth or sq_depth * 2
        self.setup = setup
        self.costs = costs
        # multi-core mode (shuffle: ring-per-worker): CPU charges go to
        # this core's busy-until clock instead of advancing the global
        # timeline, so N worker cores burn cycles concurrently
        self.core = core
        # SHARED-ring anti-pattern (one ring submitted to by N cores —
        # the opposite of SINGLE_ISSUER): every kernel-side charge is
        # serialized through a ring lock (``_lock_free`` horizon) and
        # each enter pays the lock handoff, so cores queue behind each
        # other exactly like threads on a contended SQ mutex.  The
        # scheduler re-points ``core`` at the submitting fiber's core.
        self.contended = contended
        self._lock_free = 0.0
        self.sq: deque = deque()
        self.cq: deque = deque()
        self._pending_task_work: deque = deque()   # completed, not yet CQE
        self._devices: Dict[int, object] = {}
        self._fixed_files: Dict[int, int] = {}
        self.bufs: Optional[RegisteredBuffers] = None
        self._buf_rings: Dict[int, BufferRing] = {}
        self._ms_waiters: Dict[int, tuple] = {}    # ud -> (sock, waiter fn)
        self.stats = RingStats()
        self._workers_free = [0.0] * n_workers
        self.active_workers = 0
        # SQPoll state
        self._sqpoll_busy_until = 0.0
        self._sqpoll_asleep = True
        self._chain: List[SQE] = []
        self._device_cq: deque = deque()
        self.ring_id = next(IoUring._ring_ids)   # trace track id

    # ------------------------------------------------------------------ API

    def register_device(self, fd: int, dev) -> None:
        self._devices[fd] = dev

    def register_buffers(self, buffers: List[bytearray]) -> None:
        self.bufs = RegisteredBuffers(buffers)

    def register_buf_ring(self, bgid: int, n_bufs: int,
                          buf_size: int) -> BufferRing:
        """Provided buffer ring for BUFFER_SELECT recvs (paper §4.2)."""
        br = BufferRing(bgid, [bytearray(buf_size) for _ in range(n_bufs)])
        self._buf_rings[bgid] = br
        return br

    def buf_ring_recycle(self, bgid: int, bid: int) -> None:
        self._buf_rings[bgid].recycle(bid)

    def cancel(self, user_data: int) -> bool:
        """ASYNC_CANCEL-lite: disarm a still-armed multishot recv.
        Returns True if it was armed (no CQE is posted — the caller owns
        the accounting, see FiberScheduler StreamClose)."""
        ent = self._ms_waiters.pop(user_data, None)
        if ent is None:
            return False
        sock, fn = ent
        if fn in sock.rx_waiters:
            sock.rx_waiters.remove(fn)
        return True

    def register_files(self, fds: List[int]) -> None:
        for i, fd in enumerate(fds):
            self._fixed_files[i] = fd

    def get_sqe(self) -> Optional[SQE]:
        if len(self.sq) >= self.sq_depth:
            return None
        sqe = SQE()
        self.sq.append(sqe)
        return sqe

    def sq_space_left(self) -> int:
        return self.sq_depth - len(self.sq)

    def submit(self) -> int:
        """Submit all queued SQEs. SQPoll: no syscall — the kernel thread
        picks them up (wake latency if asleep). Otherwise: one enter()."""
        if self.setup & SetupFlags.SQPOLL:
            return self._sqpoll_submit()
        return self._enter(len(self.sq), 0)

    def submit_and_wait(self, nr: int) -> int:
        if self.setup & SetupFlags.SQPOLL:
            n = self._sqpoll_submit()
            self.wait_cqes(nr)
            return n
        return self._enter(len(self.sq), nr)

    def peek_cqe(self) -> Optional[CQE]:
        self._poll_device_queues()
        if self.cq:
            cqe = self.cq.popleft()
            self.stats.cqes_reaped += 1
            if cqe.flags & CqeFlags.ZC_NOTIF:
                self.stats.zc_notif_cqes_reaped += 1
            tr = _trace.CURRENT
            if tr is not None:
                self._trace(tr, "cqe:zc_notif" if
                            cqe.flags & CqeFlags.ZC_NOTIF else "cqe",
                            self._cpu_now(), {"ud": cqe.user_data,
                                              "res": cqe.res})
            return cqe
        return None

    def wait_cqe(self) -> CQE:
        return self.wait_cqes(1)[0]

    def wait_cqes(self, nr: int) -> List[CQE]:
        """Block until nr completions are available (reaps task work —
        DeferTR runs it exactly here / in enter, per GL3)."""
        out: List[CQE] = []
        while len(out) < nr:
            c = self.peek_cqe()
            if c is not None:
                out.append(c)
                continue
            self._run_task_work()
            if self.cq:
                continue
            if not self.tl.run_next():
                raise RuntimeError(
                    f"deadlock: waiting for {nr - len(out)} more CQEs with "
                    f"an empty timeline (inflight bug?)")
        return out

    # -------------------------------------------------------------- kernel

    def _enter(self, to_submit: int, min_complete: int) -> int:
        self.stats.enters += 1
        if self.contended:
            self._charge(self.costs.ring_lock, False, "ring_lock")
        self._charge(self.costs.syscall, False, "syscall")
        tr = _trace.CURRENT
        if tr is not None:
            self._trace(tr, "enter", self._cpu_now(),
                        {"to_submit": min(to_submit, len(self.sq)),
                         "min_complete": min_complete})
        n = 0
        for _ in range(min(to_submit, len(self.sq))):
            sqe = self.sq.popleft()
            self._kernel_submit(sqe)
            n += 1
        self.stats.sqes_submitted += n
        self._run_task_work()
        if min_complete:
            self.wait_cqes_into_cq(min_complete)
        return n

    def wait_cqes_into_cq(self, nr: int) -> None:
        while len(self.cq) < nr:
            self._poll_device_queues()
            self._run_task_work()
            if len(self.cq) >= nr:
                break
            if not self.tl.run_next():
                raise RuntimeError("deadlock waiting for completions")

    def _sqpoll_submit(self) -> int:
        c = self.costs
        now = self.tl.now
        if self._sqpoll_asleep:
            # doorbell: wake the kernel thread (30 µs, paper §2.2)
            self._sqpoll_busy_until = now + c.sqpoll_wake_s
            self._sqpoll_asleep = False
            self.stats.sqpoll_wakeups += 1
        n = len(self.sq)
        t = max(now, self._sqpoll_busy_until)
        sqes = list(self.sq)
        self.sq.clear()

        def drain():
            for sqe in sqes:
                self._kernel_submit(sqe, on_sqpoll=True)
        self.tl.at(t, drain)
        self._sqpoll_busy_until = t + c.s(c.submit_floor_read) * n
        self.stats.sqes_submitted += n
        # the app spent no syscall; sqpoll core burns its own time
        self.stats.cpu_seconds_sqpoll += c.s(c.submit_floor_read) * n
        self.stats.attribute("sqpoll", "ring", c.s(c.submit_floor_read) * n)
        return n

    def _kernel_submit(self, sqe: SQE, *, on_sqpoll: bool = False) -> None:
        c = self.costs
        # CQE latency accounting: stamp the submitting CPU's clock, not
        # the (possibly lagging) global event clock — in multi-core mode
        # charges advance the core horizon only, and an inline completion
        # stamped off tl.now would report zero latency
        sqe._t_submit = self._cpu_now()
        tr = _trace.CURRENT
        if tr is not None:
            self._trace(tr, f"sqe:{op_class(sqe.op)}", sqe._t_submit,
                        {"ud": sqe.user_data})
        # linking: buffer the chain until a non-linked SQE terminates it
        if sqe.flags & SqeFlags.IO_LINK:
            self._chain.append(sqe)
            return
        if self._chain:
            chain = self._chain + [sqe]
            self._chain = []
            self._run_chain(chain)
            return
        self._issue(sqe, on_sqpoll=on_sqpoll)

    def _run_chain(self, chain: List[SQE]) -> None:
        """IO_LINK semantics: each op starts after the previous completes.
        A LINK_TIMEOUT bounds its predecessor."""

        def run(idx: int):
            if idx >= len(chain):
                return
            sqe = chain[idx]
            if sqe.op == Op.LINK_TIMEOUT:
                run(idx + 1)   # handled when its predecessor was issued
                return
            nxt = chain[idx + 1] if idx + 1 < len(chain) else None
            timeout = nxt.timeout if (nxt is not None and
                                      nxt.op == Op.LINK_TIMEOUT) else None
            self._issue(sqe, then=lambda: run(idx + 1), timeout=timeout,
                        timeout_ud=nxt.user_data if timeout else 0)
        run(0)

    def _issue(self, sqe: SQE, *, then=None, timeout=None, timeout_ud=0,
               on_sqpoll: bool = False) -> None:
        c = self.costs
        if sqe.op == Op.NOP:
            self._charge(c.submit_floor_nop, on_sqpoll, "submit_floor",
                         "nop")
            if sqe.flags & SqeFlags.ASYNC:
                self._worker_complete(sqe, 0.0, 0, then)
            else:
                self._complete(sqe, 0, CqeFlags.INLINE, then)
            return

        if sqe.op == Op.TIMEOUT:
            self.tl.at(self.tl.now + (sqe.timeout or 0.0),
                       lambda: self._complete(sqe, ETIME, CqeFlags.POLLED,
                                              then))
            return

        dev = self._resolve_device(sqe)
        if dev is None:
            self._complete(sqe, EINVAL, CqeFlags.INLINE, then)
            return

        if isinstance(dev, SimSocket):
            self._issue_socket(sqe, dev, then, on_sqpoll, timeout,
                               timeout_ud)
            return
        if isinstance(dev, FileBackend):
            self._issue_file(sqe, dev, then)
            return
        self._issue_nvme(sqe, dev, then, timeout, timeout_ud, on_sqpoll)

    # ----------------------------------------------------- storage path

    def _issue_nvme(self, sqe: SQE, dev: SimNVMe, then, timeout,
                    timeout_ud: int, on_sqpoll: bool) -> None:
        c = self.costs
        cls = op_class(sqe.op)
        write = sqe.op in (Op.WRITEV, Op.WRITE_FIXED)
        if sqe.op == Op.URING_CMD or sqe.cmd:         # NVMe passthrough
            if not dev.supports_passthrough():
                self._complete(sqe, EINVAL, CqeFlags.INLINE, then)
                return
            self.stats.passthru_cmds += 1
        else:
            self._charge(c.storage_stack, on_sqpoll, "storage_stack", cls)
        self._charge(c.submit_floor_write if write else c.submit_floor_read,
                     on_sqpoll, "submit_floor", cls)
        fixed = sqe.op in (Op.READ_FIXED, Op.WRITE_FIXED)
        if not fixed and sqe.length > 0:
            self._charge(c.pin_copy, on_sqpoll, "pin_copy", cls)
            self.stats.bounce_bytes_copied += sqe.length

        # service FIRST, content second: the device decides the result
        # (possibly -EIO or a short count under fault injection) and
        # only the bytes it actually transferred move — a failed write
        # persists nothing, a short read fills only the prefix
        path, delay, res = dev.service(sqe)
        if res > 0:
            buf = self._buf_for(sqe)
            n = min(res, sqe.length)
            if write:
                dev.content_write(sqe.offset, buf, n)
            elif sqe.op in (Op.READV, Op.READ_FIXED):
                dev.content_read(sqe.offset, buf, n)
        if sqe.flags & SqeFlags.ASYNC:
            path = "worker"
        if path == "worker":
            self._worker_complete(sqe, delay, res, then)
            return
        done_t = self.tl.now + delay
        if timeout is not None and delay > timeout:
            # linked timeout fires first: the parent op is cancelled —
            # without ever counting toward the device's inflight window
            # (it was pulled from the queue before dispatch)
            self.tl.at(self.tl.now + timeout, lambda: (
                self._complete(sqe, ECANCELED, CqeFlags.POLLED, None),
                self._complete(SQE(user_data=timeout_ud), ETIME,
                               CqeFlags.POLLED, then)))
            return
        dev.inflight += 1

        def finish():
            dev.inflight -= 1
            self._async_complete(sqe, res, then)
        self.tl.at(done_t, finish)

    # ----------------------------------------------------- network path

    def _issue_socket(self, sqe: SQE, sock: SimSocket, then,
                      on_sqpoll: bool, timeout=None,
                      timeout_ud: int = 0) -> None:
        if sqe.op in (Op.SEND, Op.SEND_ZC):
            self._issue_send(sqe, sock, then, on_sqpoll)
        else:
            self._issue_recv(sqe, sock, then, on_sqpoll, timeout,
                             timeout_ud)

    def _issue_send(self, sqe: SQE, sock: SimSocket, then,
                    on_sqpoll: bool) -> None:
        c = self.costs
        zc = sqe.op == Op.SEND_ZC
        fixed = sqe.buf_index >= 0
        self._charge(c.sock_submit, on_sqpoll, "sock_submit", "send")
        if zc or fixed:
            self._charge(c.zc_setup, on_sqpoll, "zc_setup", "send")
        else:
            self._charge(c.copy_cycles(sqe.length), on_sqpoll,
                         "bounce_copy", "send")
            self.stats.bounce_bytes_copied += sqe.length
            self.stats.sends_copied += 1
            self.stats.send_bytes_copied += sqe.length
        t_cpu = self._cpu_now()
        if sock.send_faulted(t_cpu):
            # connection reset: the message never reaches the wire —
            # ONE error CQE even for SEND_ZC (no MORE/ZC_NOTIF pair;
            # the pinned buffer is released immediately on error)
            self.tl.at(t_cpu, lambda: self._async_complete(
                sqe, ECONNRESET, then))
            return
        # data plane: if the SQE carries a buffer, ship its first
        # ``length`` bytes (captured at submission; see SimSocket)
        payload = bytes(sqe.buf[:sqe.length]) if sqe.buf is not None \
            else None
        tx_done, _ = sock.service_send(sqe.length, t_cpu, payload=payload)
        if zc:
            # kernel >= 6.0 semantics: TWO CQEs per SEND_ZC.  The first
            # (res = length, MORE set) says the request completed; the
            # ZC_NOTIF CQE fires only once the NIC has drained the
            # pinned user buffer — until then the app must not reuse it.
            self.tl.at(t_cpu, lambda: self._async_complete(
                sqe, sqe.length, None,
                flags=CqeFlags.POLLED | CqeFlags.MORE))
            notif = SQE(user_data=sqe.user_data)
            notif._t_submit = getattr(sqe, "_t_submit", t_cpu)
            self.tl.at(max(t_cpu, tx_done), lambda: self._async_complete(
                notif, 0, then,
                flags=CqeFlags.POLLED | CqeFlags.ZC_NOTIF))
        else:
            # copied send: the kernel owns a private copy once the CPU
            # work is done — completion does not wait for the wire
            self.tl.at(t_cpu,
                       lambda: self._async_complete(sqe, sqe.length, then))

    def _issue_recv(self, sqe: SQE, sock: SimSocket, then,
                    on_sqpoll: bool, timeout=None,
                    timeout_ud: int = 0) -> None:
        c = self.costs
        zc = sqe.op == Op.RECV_ZC
        fixed = sqe.buf_index >= 0
        bring = None
        if sqe.flags & SqeFlags.BUFFER_SELECT:
            bring = self._buf_rings.get(sqe.buf_group)
            if bring is None:
                self._complete(sqe, EINVAL, CqeFlags.INLINE, then)
                return
        self._charge(c.sock_submit, on_sqpoll, "sock_submit", "recv")
        if not (sqe.flags & SqeFlags.POLL_FIRST):
            # speculative inline attempt
            self._charge(c.sock_speculative, on_sqpoll,
                         "sock_speculative", "recv")
        multishot = bool(sqe.flags & SqeFlags.MULTISHOT)
        # POLL_FIRST skips the speculative inline attempt entirely —
        # popping the queue here would discard the message (the waiter
        # path below re-reads it via try_recv)
        got = None if (multishot or sqe.flags & SqeFlags.POLL_FIRST) \
            else sock.try_recv()
        if got is not None:
            if got < 0:
                # in-order connection-reset marker: the recv surfaces
                # -ECONNRESET; no provided buffer is consumed
                self._complete(sqe, ECONNRESET, CqeFlags.INLINE, then)
                return
            bid = -1
            if bring is not None:
                bid = bring.get()
                if bid is None:
                    sock.unrecv(got)
                    self.stats.buf_ring_exhausted += 1
                    tr = _trace.CURRENT
                    if tr is not None:
                        self._trace(tr, "buf_ring_exhausted",
                                    self._cpu_now(), {"ud": sqe.user_data})
                    self._complete(sqe, EAGAIN, CqeFlags.INLINE, then)
                    return
            if not (zc or fixed):
                self._charge(c.copy_cycles(got), on_sqpoll,
                             "bounce_copy", "recv")
                self.stats.bounce_bytes_copied += got
            self._deliver_payload(sqe, bring, bid, sock.last_payload)
            self._complete(sqe, got, CqeFlags.INLINE, then, buf_id=bid)
            return

        # shared with the linked-timeout event: whichever fires first
        # terminates the recv exactly once (Timeline events can't be
        # cancelled, so the loser checks the flag and does nothing)
        state = {"done": False}

        def on_ready():
            g = sock.try_recv()
            if g is None:
                return
            if g < 0:
                # connection reset: terminal even for multishot — the
                # app re-arms after re-establishing stream state
                sock.rx_waiters.remove(on_ready)
                self._ms_waiters.pop(sqe.user_data, None)
                state["done"] = True
                self._async_complete(sqe, ECONNRESET, then,
                                     flags=CqeFlags.POLLED)
                return
            bid = -1
            if bring is not None:
                bid = bring.get()
                if bid is None:
                    # buffer ring exhausted: leave the message queued and
                    # terminate the recv (multishot included) — EAGAIN,
                    # no MORE flag: the app recycles and re-arms
                    sock.unrecv(g)
                    sock.rx_waiters.remove(on_ready)
                    self._ms_waiters.pop(sqe.user_data, None)
                    self.stats.buf_ring_exhausted += 1
                    tr = _trace.CURRENT
                    if tr is not None:
                        self._trace(tr, "buf_ring_exhausted", self.tl.now,
                                    {"ud": sqe.user_data})
                    state["done"] = True
                    self._async_complete(sqe, EAGAIN, then,
                                         flags=CqeFlags.POLLED)
                    return
            if not (zc or fixed):                  # kernel->user copy
                self._charge(c.copy_cycles(g), False, "bounce_copy",
                             "recv")
                self.stats.bounce_bytes_copied += g
            self._deliver_payload(sqe, bring, bid, sock.last_payload)
            flags = CqeFlags.POLLED
            if multishot:
                flags |= CqeFlags.MORE             # armed: one SQE, more CQEs
                self.stats.multishot_recv_cqes += 1
            else:
                sock.rx_waiters.remove(on_ready)
                state["done"] = True
            self._async_complete(sqe, g, then, flags=flags, buf_id=bid)
        sock.rx_waiters.append(on_ready)
        if multishot:
            self._ms_waiters[sqe.user_data] = (sock, on_ready)
        if timeout is not None and not multishot:
            def on_timeout():
                if state["done"]:
                    return       # the recv won the race — timeout is moot
                state["done"] = True
                if on_ready in sock.rx_waiters:
                    sock.rx_waiters.remove(on_ready)
                self._ms_waiters.pop(sqe.user_data, None)
                # mirror the NVMe linked-timeout shape: parent CQE
                # ECANCELED, then the timeout's own ETIME CQE (which
                # carries the chain's ``then``); no provided buffer was
                # ever selected, so none leaks
                self._async_complete(sqe, ECANCELED, None,
                                     flags=CqeFlags.POLLED)
                self._async_complete(SQE(user_data=timeout_ud), ETIME,
                                     then, flags=CqeFlags.POLLED)
            self.tl.at(self.tl.now + timeout, on_timeout)
        # drain anything already queued (multishot: one CQE per message)
        while sock.rx_queue and on_ready in sock.rx_waiters:
            before = len(sock.rx_queue)
            on_ready()
            if len(sock.rx_queue) == before:
                break

    def _deliver_payload(self, sqe: SQE, bring, bid: int, payload) -> None:
        """Data plane of a recv: place the message's payload bytes (if
        the sender attached any) where the app will look — the selected
        provided-buffer-ring slot, or the SQE's own buffer."""
        if payload is None:
            return
        if bring is not None and bid >= 0:
            bring.buffers[bid][:len(payload)] = payload
        elif sqe.buf is not None:
            sqe.buf[:len(payload)] = payload

    # ----------------------------------------------------- file path

    def _issue_file(self, sqe: SQE, dev: FileBackend, then) -> None:
        buf = self._buf_for(sqe)
        if sqe.op in (Op.READV, Op.READ_FIXED):
            res = dev.pread(buf, sqe.offset, sqe.length)
            self._complete(sqe, res, CqeFlags.INLINE, then)
        elif sqe.op in (Op.WRITEV, Op.WRITE_FIXED):
            res = dev.pwrite(buf, sqe.offset, sqe.length)
            self._complete(sqe, res, CqeFlags.INLINE, then)
        elif sqe.op == Op.FSYNC:
            self._worker_complete(sqe, 0.0, dev.fsync(), then)
        else:
            self._complete(sqe, EINVAL, CqeFlags.INLINE, then)

    # ----------------------------------------------------- completion

    def _worker_complete(self, sqe: SQE, device_delay: float, res: int,
                         then) -> None:
        """io_worker fallback: +7.3 µs overhead, bounded pool (§2.2)."""
        c = self.costs
        i = min(range(len(self._workers_free)),
                key=lambda j: self._workers_free[j])
        start = max(self.tl.now, self._workers_free[i])
        done = start + c.worker_overhead_s + device_delay
        self._workers_free[i] = done
        self.stats.worker_fallbacks += 1
        self.active_workers += 1

        def finish():
            self.active_workers -= 1
            self._async_complete(sqe, res, then, flags=CqeFlags.WORKER)
        self.tl.at(done, finish)

    def _note_result(self, sqe: SQE, res: int) -> None:
        """Error/short-I/O bookkeeping for every posted CQE.  Real
        device/link errors only: pacing TIMEOUT ops completing ETIME,
        cancels, and EAGAIN (buffer-ring exhaustion, separately
        counted) are normal control flow, not faults."""
        st = self.stats
        if res in (EIO, ECONNRESET, ENOTSUP):
            st.error_cqes += 1
        elif res == ETIME and sqe.op not in (Op.NOP, Op.TIMEOUT,
                                             Op.LINK_TIMEOUT):
            st.error_cqes += 1     # device-side command timeout
        elif 0 < res < sqe.length and sqe.op in (
                Op.READV, Op.READ_FIXED, Op.WRITEV, Op.WRITE_FIXED):
            st.short_cqes += 1

    def _async_complete(self, sqe: SQE, res: int, then,
                        flags: CqeFlags = CqeFlags.POLLED,
                        buf_id: int = -1) -> None:
        c = self.costs
        iopoll = bool(self.setup & SetupFlags.IOPOLL)
        self._note_result(sqe, res)
        if flags & CqeFlags.ZC_NOTIF:
            self.stats.zc_notifs += 1
            tr = _trace.CURRENT
            if tr is not None:
                self._trace(tr, "zc_notif", self.tl.now,
                            {"ud": sqe.user_data})
        cqe = CQE(user_data=sqe.user_data, res=res, flags=flags,
                  buf_id=buf_id,
                  t_submit=getattr(sqe, "_t_submit", self.tl.now),
                  t_complete=self.tl.now)
        if res >= 0:
            self.stats.record_latency(
                "zc_notif" if flags & CqeFlags.ZC_NOTIF
                else op_class(sqe.op), cqe.latency)
        if iopoll:
            self._device_cq.append(cqe)
        else:
            self._pending_task_work.append(cqe)
            if not (self.setup & SetupFlags.DEFER_TASKRUN):
                # default & CoopTR: task work runs on the next kernel
                # transition; default mode may IPI-preempt a busy app core
                if not (self.setup & SetupFlags.COOP_TASKRUN):
                    self._charge(c.preempt_ipi, False, "ipi")
                self._run_task_work()
        if then:   # IO_LINK chain progression is kernel-side
            then()

    def _poll_device_queues(self) -> None:
        if not (self.setup & SetupFlags.IOPOLL):
            return
        c = self.costs
        while self._device_cq:
            cqe = self._device_cq.popleft()
            self._charge(c.complete_polled, False, "complete_poll")
            self.cq.append(cqe)
            self.stats.polled_completions += 1

    def _run_task_work(self) -> None:
        c = self.costs
        while self._pending_task_work:
            cqe = self._pending_task_work.popleft()
            self._charge(c.task_work, False, "task_work")
            if not (cqe.flags & CqeFlags.WORKER) and \
                    not (self.setup & SetupFlags.IOPOLL):
                self._charge(c.complete_irq, False, "complete_irq")
            self.cq.append(cqe)

    def _complete(self, sqe: SQE, res: int, flags: CqeFlags, then,
                  buf_id: int = -1) -> None:
        # t_complete off the submitting CPU's clock (see _kernel_submit):
        # inline completions in multi-core mode otherwise collapse to
        # zero latency because charges never advance the event clock
        self._note_result(sqe, res)
        cqe = CQE(user_data=sqe.user_data, res=res, flags=flags,
                  buf_id=buf_id,
                  t_submit=getattr(sqe, "_t_submit", self.tl.now),
                  t_complete=self._cpu_now())
        if res >= 0:
            self.stats.record_latency(op_class(sqe.op), cqe.latency)
        self.cq.append(cqe)
        if flags & CqeFlags.INLINE:
            self.stats.inline_completions += 1
        if then:
            then()

    # ----------------------------------------------------- helpers

    def _resolve_device(self, sqe: SQE):
        fd = sqe.fd
        if sqe.flags & SqeFlags.FIXED_FILE:
            fd = self._fixed_files.get(fd, -1)
        return self._devices.get(fd)

    def _buf_for(self, sqe: SQE):
        if sqe.buf_index >= 0 and self.bufs is not None:
            return self.bufs[sqe.buf_index]
        return sqe.buf

    def _cpu_now(self) -> float:
        """The submitting CPU's current time: the core horizon in
        multi-core mode, the global clock otherwise (where charges have
        already advanced it)."""
        if self.core is not None:
            return max(self.tl.now, self.core.free)
        return self.tl.now

    def _trace(self, tr, name: str, ts: float,
               args: Optional[dict] = None) -> None:
        """Emit one instant on this ring's trace track (reads clocks
        only — never charges or advances them)."""
        pid = _trace.RING_PID_BASE + self.ring_id
        tr.process_name(pid, f"ring{self.ring_id}")
        tr.instant(name, ts, pid, 0, args)

    def register_metrics(self, reg, prefix: str) -> None:
        """Ring stat surface for the opt-in telemetry sampler
        (``repro.observe.metrics``): cumulative counters, windowed
        batch efficiency, windowed attribution shares of charged CPU,
        the CQ backlog gauge, and per-op-class latency digests.  Every
        source is a pure read of ``self.stats``/queues."""
        st = self.stats
        reg.counter(f"{prefix}/enters", lambda: st.enters)
        reg.counter(f"{prefix}/sqes", lambda: st.sqes_submitted)
        reg.counter(f"{prefix}/cqes", lambda: st.cqes_reaped)
        reg.counter(f"{prefix}/worker_fallbacks",
                    lambda: st.worker_fallbacks)
        reg.counter(f"{prefix}/error_cqes", lambda: st.error_cqes)
        reg.counter(f"{prefix}/short_cqes", lambda: st.short_cqes)
        reg.counter(f"{prefix}/passthru_fallbacks",
                    lambda: st.passthru_fallbacks)
        reg.wrate(f"{prefix}/batch_eff", lambda: st.sqes_submitted,
                  lambda: st.enters, unit="sqe/enter")
        reg.gauge(f"{prefix}/cq_backlog",
                  lambda: len(self.cq) + len(self._pending_task_work))
        reg.wgroup(f"{prefix}/attr", lambda: st.attribution,
                   lambda: st.cpu_seconds_app + st.cpu_seconds_sqpoll)
        reg.hists(f"{prefix}/lat", lambda: st.lat)

    def _charge(self, cycles: float, on_sqpoll: bool, cat: str,
                op_cls: str = "ring") -> None:
        """Charge ``cycles`` to the right clock AND attribute the same
        seconds to ``(cat, op_cls)`` — the conservation invariant
        (attribution sums back to the cpu_seconds totals) holds because
        this is the only place app/sqpoll seconds accumulate, except
        ``_sqpoll_submit``'s polling floor which self-attributes."""
        if cycles == 0:
            return
        dt = self.costs.s(cycles)
        self.stats.attribute(cat, op_cls, dt)
        if on_sqpoll:
            self.stats.cpu_seconds_sqpoll += dt
            self._sqpoll_busy_until = max(self._sqpoll_busy_until,
                                          self.tl.now) + dt
        elif self.core is not None:
            # multi-core: occupy this ring's core; the global clock only
            # advances through the event heap (see CoreClock)
            self.stats.cpu_seconds_app += dt
            if self.contended:
                # shared ring: the charge also holds the ring lock, so
                # other cores' ring work queues behind it.  The stall
                # spent spinning on the lock is burned CPU on THIS core
                # — attributed as ring_lock, the advisor's shared-ring
                # signature (still conserved: it joins cpu_seconds_app)
                free0 = max(self.tl.now, self.core.free)
                t0 = max(free0, self._lock_free)
                wait = t0 - free0
                if wait > 0.0:
                    self.stats.cpu_seconds_app += wait
                    self.stats.attribute("ring_lock", "ring", wait)
                self.core.free = t0 + dt
                self._lock_free = self.core.free
            else:
                self.core.charge(self.tl.now, dt)
        else:
            self.stats.cpu_seconds_app += dt
            self.tl.run_until(self.tl.now + dt)


# ---------------------------------------------------------------------------
# prep_* helpers (liburing style)
# ---------------------------------------------------------------------------

def _prep(sqe: SQE, op: Op, fd: int, buf, offset: int, length: int,
          user_data: int, flags: SqeFlags) -> SQE:
    sqe.op = op
    sqe.fd = fd
    sqe.buf = buf
    sqe.offset = offset
    sqe.length = length
    sqe.user_data = user_data
    sqe.flags = flags
    return sqe


def prep_read(sqe, fd, buf, offset, length, user_data=0,
              flags=SqeFlags.NONE):
    return _prep(sqe, Op.READV, fd, buf, offset, length, user_data, flags)


def prep_write(sqe, fd, buf, offset, length, user_data=0,
               flags=SqeFlags.NONE):
    return _prep(sqe, Op.WRITEV, fd, buf, offset, length, user_data, flags)


def prep_read_fixed(sqe, fd, buf_index, offset, length, user_data=0,
                    flags=SqeFlags.NONE):
    s = _prep(sqe, Op.READ_FIXED, fd, None, offset, length, user_data, flags)
    s.buf_index = buf_index
    return s


def prep_write_fixed(sqe, fd, buf_index, offset, length, user_data=0,
                     flags=SqeFlags.NONE):
    s = _prep(sqe, Op.WRITE_FIXED, fd, None, offset, length, user_data,
              flags)
    s.buf_index = buf_index
    return s


def prep_fsync(sqe, fd, user_data=0, flags=SqeFlags.NONE, nvme_flush=False):
    s = _prep(sqe, Op.FSYNC, fd, None, 0, 0, user_data, flags)
    if nvme_flush:
        s.cmd = "nvme-flush"
    return s


def prep_send(sqe, fd, length, user_data=0, flags=SqeFlags.NONE,
              zero_copy=False, buf_index=-1, buf=None):
    """``buf``: optional payload bytes to carry on the data plane (log
    shipping); size-only senders (the shuffle) omit it."""
    s = _prep(sqe, Op.SEND_ZC if zero_copy else Op.SEND, fd, buf, 0,
              length, user_data, flags)
    s.buf_index = buf_index
    return s


def prep_recv(sqe, fd, length=0, user_data=0, flags=SqeFlags.NONE,
              zero_copy=False, buf_index=-1, buf_group=-1, buf=None):
    """``buf``: landing buffer for the message payload when no provided
    buffer ring is used (with BUFFER_SELECT the payload lands in the
    selected ring slot instead and ``CQE.buf_id`` names it)."""
    s = _prep(sqe, Op.RECV_ZC if zero_copy else Op.RECV, fd, buf, 0,
              length, user_data, flags)
    s.buf_index = buf_index
    if buf_group >= 0:
        s.buf_group = buf_group
        s.flags |= SqeFlags.BUFFER_SELECT
    return s


def prep_nop(sqe, user_data=0, flags=SqeFlags.NONE):
    return _prep(sqe, Op.NOP, -1, None, 0, 0, user_data, flags)


def prep_timeout(sqe, seconds, user_data=0, flags=SqeFlags.NONE):
    s = _prep(sqe, Op.TIMEOUT, -1, None, 0, 0, user_data, flags)
    s.timeout = seconds
    return s


def prep_link_timeout(sqe, seconds, user_data=0):
    """Bounds the PREVIOUS (IO_LINK'd) op — hedged-read building block."""
    s = _prep(sqe, Op.LINK_TIMEOUT, -1, None, 0, 0, user_data,
              SqeFlags.NONE)
    s.timeout = seconds
    return s


def prep_uring_cmd(sqe, fd, cmd, buf=None, offset=0, length=0, user_data=0,
                   flags=SqeFlags.NONE):
    s = _prep(sqe, Op.URING_CMD, fd, buf, offset, length, user_data, flags)
    s.cmd = cmd
    return s
