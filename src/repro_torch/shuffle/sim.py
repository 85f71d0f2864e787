"""Analytical shuffle oracle (paper §4): closed-form timing over the
SAME data movement as the ring-driven engine.

This module used to be the only shuffle implementation; it is now the
*cross-validation oracle* for ``shuffle.engine``.  Both iterate the
identical morsel/chunk plan (``shuffle.plan``) and pace transfers
through the identical per-flow fair-share link model
(``core.backends.SimNetwork.flow_schedule``); the oracle charges each
step's CPU in closed form (one arithmetic expression per chunk) where
the engine earns it SQE by SQE through ``core.ring``.  Agreement within
a few percent is asserted in tests/test_shuffle.py; disagreement beyond
that flags a timing-model regression in either side.

Syscall accounting is structural, not assumed: with one staging buffer
per destination, all ``n_nodes - 1`` buffers fill on the same morsel,
so the engine submits their sends as ONE ``io_uring_enter`` — the
oracle charges ``syscall / sends_per_enter`` with
``sends_per_enter = n_nodes - 1`` for io_uring (and 1 for the epoll
baseline, which also pays a syscall per recv).  Multishot recv re-arms
in kernel space: zero recv syscalls for io_uring.

Per-tuple probe-table inserts are charged a random-memory-access stall
(the paper's "small tuples limit throughput" effect, Fig. 11), and every
kernel<->user copy is accounted against a node-level memory-bandwidth
budget (Fig. 12).
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass
from typing import Dict

from repro_torch.core.backends import NICSpec, SimNetwork
from repro_torch.core.costs import DEFAULT_COSTS, CostModel
from repro_torch.shuffle.plan import morsel_plan, receiver_worker

KiB, MiB = 1024, 1024 * 1024


def _chain(head, rest):
    """Push one lookahead item back onto an iterator."""
    return itertools.chain([head], rest)


@dataclass
class ShuffleConfig:
    n_nodes: int = 6
    n_workers: int = 32
    tuple_size: int = 512
    total_bytes_per_node: int = 512 * MiB
    chunk_bytes: int = 1 * MiB
    zc_send: bool = False
    zc_recv: bool = False
    iface: str = "uring"             # uring | epoll
    build_probe_table: bool = True
    # hardware model
    link_bw: float = 50e9            # 400 Gbit/s per direction
    mem_bw: float = 400e9            # node memory bandwidth (Fig. 12)
    # effective probe-insert cost: the engine uses batched inserts with
    # software prefetch (paper cites Birler et al. [10]), which hides most
    # of the ~90 ns DRAM latency behind concurrent loads
    dram_stall_s: float = 25e-9
    scan_cost_per_byte: float = 0.004e-9
    partition_cost_per_tuple: float = 3e-9
    tuned_network: bool = True       # Fig. 14: qdisc/socket-buffer tuning
    # receive-side provided-buffer ring; when a flow carries more
    # chunks than this, the ring runs dry and the receiver falls into
    # its exhaustion/re-arm drain cycle (modeled by engine AND oracle)
    rx_buffers: int = 16
    # socket/TCP send-buffer depth in chunks per flow: a sender blocks
    # once this many chunks are in flight ahead of the receiver's
    # processing (kernel socket buffers hold several MiB — much deeper
    # than the provided-buffer ring, so this binds only on flows far
    # longer than rx_buffers)
    tx_window_chunks: int = 48

    def nic_spec(self) -> NICSpec:
        return NICSpec(bw=self.link_bw)


class ShuffleSim:
    """Event-driven closed-form oracle. Events: (time, seq, fn)."""

    def __init__(self, cfg: ShuffleConfig, costs: CostModel = DEFAULT_COSTS):
        self.cfg = cfg
        self.costs = costs
        self.now = 0.0
        self._heap: list = []
        self._seq = itertools.count()
        n = cfg.n_nodes
        # per-(node, worker) core clock
        self.core_free = [[0.0] * cfg.n_workers for _ in range(n)]
        # shared link model: tx lane per node, fair-share rx lane per flow
        # (pure clock arithmetic — no timeline needed)
        self.net = SimNetwork(None, n, cfg.nic_spec(),
                              tuned=cfg.tuned_network)
        self.mem_free = [0.0] * n     # node memory-bandwidth meter
        self._zc_pending: Dict = {}   # (src, worker) -> unreaped tx_done
        # receive-side queueing feedback (ROADMAP gap (a), now modeled):
        # the engine's provided-buffer ring holds cfg.rx_buffers chunks
        # per inbound flow, and a chunk's buffer recycles only when its
        # probe work completes — so a sender may run at most that many
        # chunks ahead of the receiver's processing.  Chunk k of a flow
        # must wait for chunk k - rx_buffers to finish; when that
        # completion is not yet known, the sending worker PARKS here
        # and probe_ev resumes it (event-driven, like a fiber blocking
        # on a full buffer ring — an inline lower bound cannot work
        # because every send fires, in event time, before any receive
        # processing is booked)
        self._flow_sent: Dict = {}     # flow -> chunks entered so far
        self._flow_seen: Dict = {}     # flow -> chunks arrived so far
        self._flow_done: Dict = {}     # flow -> processed-chunk times
        self._flow_waiters: Dict = {}  # flow -> parked resumes
        self.sent = [0] * n
        self.received = [0] * n
        self.mem_bytes = [0] * n      # memory traffic (copies + probe)
        self.syscalls = [0.0] * n
        self.cpu_busy = [0.0] * n
        self.t_end = 0.0

    # ------------------------------------------------------------- events

    def _at(self, t, fn):
        heapq.heappush(self._heap, (t, next(self._seq), fn))

    def _drain(self):
        while self._heap:
            t, _, fn = heapq.heappop(self._heap)
            self.now = max(self.now, t)
            fn()

    # ------------------------------------------------------------- model

    def _charge(self, node: int, worker: int, start: float,
                seconds: float, mem_bytes: int = 0) -> float:
        """Charge CPU on one core (+ node memory-bandwidth contention);
        returns completion time."""
        t0 = max(start, self.core_free[node][worker])
        t1 = t0 + seconds
        if mem_bytes:
            m0 = max(t0, self.mem_free[node])
            m1 = m0 + mem_bytes / self.cfg.mem_bw
            self.mem_free[node] = m1
            t1 = max(t1, m1)
        self.core_free[node][worker] = t1
        self.cpu_busy[node] += seconds
        return t1

    def _cqe_s(self) -> float:
        """Completion handling per CQE (mirrors ring._run_task_work:
        task-work placement + IRQ; the epoll baseline also eats the
        IPI preemption of default task-running mode)."""
        c = self.costs
        cyc = c.task_work + c.complete_irq
        if self.cfg.iface == "epoll":
            cyc += c.preempt_ipi
        return c.s(cyc)

    def _send_chunk(self, src: int, dst: int, nbytes: int, t: float,
                    worker: int) -> float:
        """CPU (submit + optional copy) then link pacing; schedules the
        remote probe work at arrival. Returns sender-side completion."""
        cfg, c = self.cfg, self.costs
        cpu = c.s(c.sock_submit)
        if cfg.iface == "epoll":
            cpu += c.s(c.syscall)              # one syscall per send
            self.syscalls[src] += 1
        else:
            # one enter covers the (n_nodes - 1) sends whose staging
            # buffers fill on the same morsel — see shuffle.plan
            sends_per_enter = max(1, cfg.n_nodes - 1)
            cpu += c.s(c.syscall) / sends_per_enter
            self.syscalls[src] += 1 / sends_per_enter
        if cfg.zc_send:
            cpu += c.s(c.zc_setup)
            cpu += 2 * self._cqe_s()           # completion + ZC_NOTIF CQEs
        else:
            cpu += c.s(c.copy_cycles(nbytes))
            cpu += self._cqe_s()
        # NB: the staging memory traffic was charged by the caller for
        # the WHOLE batch before any copy ran (engine charge order)
        t_cpu = self._charge(src, worker, t, cpu)

        # shared pacing model: tx lane at link rate, fair-share rx lane
        # per (dst, src) flow; untuned stacks lose ~25% to flow imbalance
        # (worker steps fire in global time order, so the shared lanes
        # are paced in order too)
        self.sent[src] += nbytes
        tx_done, arrive = self.net.flow_schedule(src, dst, nbytes, t_cpu)
        self._at(arrive, lambda: self._on_recv(dst, src, nbytes, arrive))
        if cfg.zc_send:
            # ZC_NOTIF backpressure: the staging buffer stays pinned
            # until the NIC drains it; with a double-buffer per
            # destination the worker stalls once 2×(n-1) notifs are
            # outstanding (mirrors ShuffleEngine._sender's reaping)
            q = self._zc_pending.setdefault((src, worker), [])
            q.append(tx_done)
            if len(q) > 2 * (cfg.n_nodes - 1):
                t_cpu = max(t_cpu, q.pop(0))
        return t_cpu

    def _on_recv(self, node: int, src: int, nbytes: int, t: float) -> None:
        flow = (node, src)
        k = self._flow_seen.get(flow, 0)
        self._flow_seen[flow] = k + 1
        self._rx_ready(node, src, nbytes, t, k)

    def _rx_ready(self, node: int, src: int, nbytes: int, t: float,
                  k: int) -> None:
        """Admit arrived chunk k of flow (node, src) once the engine's
        receiver could actually see its CQE.  With a provided-buffer
        ring of ``rx_buffers`` chunks, the (win+1)'th arrival finds the
        ring dry: the multishot recv dies with EAGAIN and the receiver
        fiber sleeps until every queued probe completes, then re-arms
        and drains (see ShuffleEngine._receiver).  So chunks of window
        m >= 1 are not even COPIED before the probe of the last window
        m-1 chunk finishes — the rx-queueing feedback the closed form
        used to miss (ROADMAP gap (a))."""
        cfg, c = self.cfg, self.costs
        win = cfg.rx_buffers
        if cfg.iface != "epoll" and k >= win:
            need = win * (k // win) - 1
            done = self._flow_done.get((node, src), ())
            if len(done) <= need:
                self._flow_waiters.setdefault((node, src), []).append(
                    lambda t2: self._rx_ready(node, src, nbytes,
                                              max(t, t2), k))
                return
            t = max(t, done[need])
            if k % win == 0:
                # the exhaustion itself: one dead EAGAIN CQE, a timeout
                # SQE to sleep on, and the re-arm submit
                t = self._charge(node, receiver_worker(cfg, node, src),
                                 t, self._cqe_s() +
                                 c.s(c.syscall + c.sock_submit))
            self._rx_chunk(node, src, nbytes, t, drained=True)
            return
        self._rx_chunk(node, src, nbytes, t)

    def _rx_chunk(self, node: int, src: int, nbytes: int,
                  t: float, drained: bool = False) -> None:
        cfg, c = self.cfg, self.costs
        self.received[node] += nbytes
        membytes = nbytes                      # NIC DMA write
        w = receiver_worker(cfg, node, src)
        cpu = self._cqe_s()                    # recv completion handling
        if cfg.iface == "epoll":
            # single-shot recv: re-arm syscall + submit path per chunk
            cpu += c.s(c.syscall + c.sock_submit + c.sock_speculative)
            self.syscalls[node] += 1
        # else: multishot recv stays armed — zero syscalls, zero submits
        if not cfg.zc_recv:
            cpu += c.s(c.copy_cycles(nbytes))
            membytes += 2 * nbytes
        probe = 0.0
        if cfg.build_probe_table:
            n_tuples = nbytes // cfg.tuple_size
            probe = n_tuples * (cfg.dram_stall_s +
                                cfg.partition_cost_per_tuple)
            membytes += n_tuples * 64          # cacheline per insert
        self.mem_bytes[node] += membytes
        # same charge order as the engine's receiver fiber: the ring
        # burns the kernel-side copy when the CQE fires, then _consume
        # books the probe work (which carries the memory traffic) at
        # the core's horizon immediately — even when that reserves the
        # node memory meter at far-future core times (the meter is one
        # FIFO lane, so bookings must land in the same order the
        # engine makes them; see ShuffleEngine._consume)
        t1 = self._charge(node, w, t, cpu)
        t2 = self._charge(node, w, t1, probe, mem_bytes=membytes)
        # chunk fully processed: its provided buffer recycles at t2,
        # releasing one window slot of this flow — resume any parked
        # senders/receivers
        self._flow_done.setdefault((node, src), []).append(t2)
        for fn in self._flow_waiters.pop((node, src), []):
            fn(t2)
        self.t_end = max(self.t_end, t2)

    # ------------------------------------------------------------- run

    def run(self) -> Dict:
        cfg = self.cfg
        n = cfg.n_nodes

        # Each worker advances one morsel (plus the chunk flushes it
        # triggers) per EVENT, re-scheduled at its own running clock, so
        # every core/memory-meter/link booking across all workers and
        # all arrivals happens in global time order.  Booking a worker's
        # whole plan up front would reserve the shared node memory meter
        # far into the future and push every rx charge behind it — a
        # convoy the engine's scheduler never exhibits.
        plans = {(src, w): morsel_plan(cfg, src, w)
                 for src in range(n) for w in range(cfg.n_workers)}
        clocks = {key: 0.0 for key in plans}

        def step(key):
            src, w = key
            t = clocks[key]
            # fire when the core is actually free (rx work may have
            # intruded since this step was scheduled) — the engine's
            # scheduler resumes fibers the same way; without this, a
            # deferred worker books the shared memory meter at far-future
            # core times, convoying every later rx charge behind it
            avail = max(t, self.core_free[src][w])
            if avail > t:
                clocks[key] = avail
                self._at(avail, lambda: step(key))
                return
            ev = next(plans[key], None)
            if ev is None:
                self.t_end = max(self.t_end, t)
                return
            # one step = one fiber burst: the engine's sender fiber
            # books every morsel charge back-to-back (pure clock
            # arithmetic, no yield) until a send batch forces it to
            # enter the kernel — so the oracle consumes consecutive
            # morsels plus the first send batch per event.  Matching
            # the yield granularity matters: each burst books the
            # shared node memory meter at this worker's growing core
            # times, and the meter (one FIFO lane) idles between a
            # burst's bookings exactly as it does under the engine.
            sends = []
            while ev is not None:
                if ev[0] == "morsel":
                    if sends:          # fiber yields (flushes) before
                        plans[key] = _chain(ev, plans[key])
                        break          # the next morsel runs
                    _, nb, n_tuples, local = ev
                    # scan + partition the morsel
                    cpu = nb * cfg.scan_cost_per_byte + \
                        n_tuples * cfg.partition_cost_per_tuple
                    self.mem_bytes[src] += nb          # scan read
                    t = self._charge(src, w, t, cpu, mem_bytes=nb)
                    if cfg.build_probe_table and local:
                        lt = local // cfg.tuple_size
                        t = self._charge(src, w, t,
                                         lt * cfg.dram_stall_s)
                        self.mem_bytes[src] += lt * 64
                else:
                    sends.append((ev[1], ev[2]))
                ev = next(plans[key], None)
            if sends:
                # engine charge order: stage every chunk of the batch
                # (one contiguous meter booking), THEN burn the per-send
                # submit/copy CPU while the meter serves other cores
                for dst, nbytes in sends:
                    membytes = nbytes if cfg.zc_send else 3 * nbytes
                    self.mem_bytes[src] += membytes
                    t = self._charge(src, w, t, 0.0, mem_bytes=membytes)
                flush_sends(key, sends, 0, t)
                return
            clocks[key] = t
            self._at(t, lambda: step(key))

        def flush_sends(key, sends, i, t):
            """Send sends[i:], honoring the per-flow socket-buffer
            window (tx_window_chunks).  Parks (returns without
            rescheduling step) when a flow's window is full and the
            releasing completion is not yet known; probe_ev re-enters
            here once the receiver catches up."""
            src, w = key
            win = cfg.tx_window_chunks
            while i < len(sends):
                dst, nbytes = sends[i]
                flow = (dst, src)
                k = self._flow_sent.get(flow, 0)
                if k >= win:
                    done = self._flow_done.get(flow, ())
                    if len(done) <= k - win:
                        self._flow_waiters.setdefault(flow, []).append(
                            lambda t2, i=i, t=t: flush_sends(
                                key, sends, i, max(t, t2)))
                        return
                    t = max(t, done[k - win])
                self._flow_sent[flow] = k + 1
                t = self._send_chunk(src, dst, nbytes, t, w)
                i += 1
            clocks[key] = t
            self._at(t, lambda: step(key))

        for key in plans:
            self._at(0.0, lambda key=key: step(key))
        self._drain()
        dur = max(self.t_end, self.now, 1e-9)
        egress = [s / dur for s in self.sent]
        return {
            "duration_s": dur,
            "egress_gib_per_node": sum(egress) / n / 2**30,
            "egress_gbit_per_node": sum(egress) / n * 8 / 1e9,
            "mem_gib_s": sum(self.mem_bytes) / n / dur / 2**30,
            "mem_per_net_byte": (sum(self.mem_bytes) /
                                 max(1, sum(self.sent) + sum(self.received))),
            "syscalls": sum(self.syscalls),
            "cpu_busy_frac": sum(self.cpu_busy) /
                             (n * cfg.n_workers * dur),
        }
