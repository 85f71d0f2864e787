"""Ring-driven shuffle engine (paper §4): the REAL runtime, not a model.

Morsel-driven workers run as fibers on a multi-core ``FiberScheduler``
— ``n_nodes × n_workers`` simulated cores, ring-per-worker — and move
every byte through actual SEND/RECV (and SEND_ZC/RECV_ZC) SQEs over
``SimSocket`` endpoints:

  * senders scan morsels, stage tuples per destination, and flush 1 MiB
    chunks; all destination buffers fill on the same morsel, so their
    sends enter the kernel as ONE ``io_uring_enter`` — batching is
    *earned* through ``RingStats.enters``, never assumed;
  * SEND_ZC pins the staging buffer until the deferred ``ZC_NOTIF``
    CQE releases it (reaped with ``StreamRead``), bounding zero-copy
    sends by a double-buffer per destination exactly like a real
    engine must;
  * one receiver fiber per inbound flow arms a MULTISHOT recv backed by
    a provided buffer ring (``register_buf_ring``): one SQE yields a
    CQE per arriving chunk (``CqeFlags.MORE``) with zero re-arm
    syscalls, terminating with EAGAIN when the buffer ring runs dry;
  * ``iface="epoll"`` is the baseline: the same fibers, but one enter
    per I/O (``per_op_submit``), single-shot recvs, and interrupt-mode
    completion (no DEFER_TASKRUN) — Fig. 13's comparison point.

CPU is charged per-core (``CoreClock``), link pacing is the shared
per-flow fair-share model in ``core.backends.SimNetwork``, and data
movement follows ``shuffle.plan`` — all three shared with the
analytical oracle in ``shuffle.sim``, which cross-validates this
engine's egress (see tests/test_shuffle.py and
benchmarks/bench_shuffle.py).
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List

from repro_torch.core.backends import SimNetwork, SimSocket
from repro_torch.core.costs import DEFAULT_COSTS, CostModel
from repro_torch.core.faults import maybe_plane
from repro_torch.core.fibers import (FiberScheduler, IoRequest, StreamClose,
                                     StreamRead)
from repro_torch.core.ring import IoUring, prep_recv, prep_send, prep_timeout
from repro_torch.core.sqe import EAGAIN, CqeFlags, SetupFlags, SqeFlags
from repro_torch.core.timeline import CoreClock, Timeline
from repro_torch.shuffle.plan import (expected_flow_bytes, morsel_plan,
                                      receiver_worker)
from repro_torch.shuffle.sim import ShuffleConfig


class ShuffleEngine:
    """One shuffle execution over the ring runtime."""

    def __init__(self, cfg: ShuffleConfig,
                 costs: CostModel = DEFAULT_COSTS, faults=None):
        self.cfg = cfg
        self.costs = costs
        self.tl = Timeline()
        n = cfg.n_nodes
        self.net = SimNetwork(self.tl, n, cfg.nic_spec(),
                              tuned=cfg.tuned_network)
        # fault plane (repro.core.faults): link flaps roll on the
        # SENDING socket, so the plane attaches to every mesh endpoint;
        # None/all-zero leaves the mesh untouched
        self.faults = maybe_plane(faults)
        # full-duplex socket mesh: socks[a][b] is a's endpoint toward b
        self.socks: List[List[SimSocket]] = \
            [[None] * n for _ in range(n)]
        for a in range(n):
            for b in range(a + 1, n):
                sa, sb = SimSocket.pair(self.net, a, b)
                self.socks[a][b], self.socks[b][a] = sa, sb
                if self.faults is not None:
                    sa.faults = self.faults
                    sb.faults = self.faults

        epoll = cfg.iface == "epoll"
        setup = SetupFlags.NONE if epoll else \
            (SetupFlags.DEFER_TASKRUN | SetupFlags.SINGLE_ISSUER)
        self.cores: List[CoreClock] = []
        self.rings: List[IoUring] = []
        for node in range(n):
            for _ in range(cfg.n_workers):
                core = CoreClock()
                ring = IoUring(self.tl, sq_depth=256, setup=setup,
                               costs=costs, core=core)
                for d in range(n):           # fd = peer node id
                    if d != node:
                        ring.register_device(d, self.socks[node][d])
                self.cores.append(core)
                self.rings.append(ring)
        from repro_torch.core.adaptive import EagerSubmit
        self.sched = FiberScheduler(rings=self.rings, cores=self.cores,
                                    policy=EagerSubmit(),
                                    per_op_submit=epoll)
        # node-level meters (identical accounting to the oracle)
        self.mem_free = [0.0] * n
        self.mem_bytes = [0] * n
        self.cpu_busy_app = [0.0] * n        # scan/partition/probe work
        self.sent = [0] * n
        self.received = [0] * n
        self.expected = expected_flow_bytes(cfg)
        # error-recovery surfaces: chunks lost to a link flap (and
        # un-counted from ``sent``), re-send rounds, resets seen by
        # receivers
        self.send_errors = 0
        self.resends = 0
        self.conn_resets = 0

    # ---------------------------------------------------------- helpers

    def _slot(self, node: int, worker: int) -> int:
        return node * self.cfg.n_workers + worker

    def _charge(self, node: int, core: CoreClock, cpu_s: float,
                mem_bytes: int = 0) -> float:
        """Application-level CPU on one core + node memory-bandwidth
        contention (mirrors the oracle's ``_charge``).  Pure clock
        arithmetic: the global timeline only advances through events.
        Returns the virtual completion time."""
        t0 = max(self.tl.now, core.free)
        t1 = t0 + cpu_s
        if mem_bytes:
            m0 = max(t0, self.mem_free[node])
            m1 = m0 + mem_bytes / self.cfg.mem_bw
            self.mem_free[node] = m1
            t1 = max(t1, m1)
        core.free = t1
        self.cpu_busy_app[node] += cpu_s
        self.mem_bytes[node] += mem_bytes
        return t1

    # ----------------------------------------------------------- fibers

    def _sender(self, src: int, worker: int):
        """Morsel loop: scan, stage, flush chunk sends in one batch."""
        cfg = self.cfg
        core = self.cores[self._slot(src, worker)]
        zc = cfg.zc_send
        pending_notifs: deque = deque()
        # double-buffer per destination: a zc send's staging buffer is
        # pinned until its ZC_NOTIF arrives, so at most 2×(n-1) sends
        # may be outstanding before the worker must reap
        max_pinned = 2 * (cfg.n_nodes - 1)
        batch: List = []
        for ev in list(morsel_plan(cfg, src, worker)) + [("end",)]:
            if ev[0] == "send":
                batch.append((ev[1], ev[2]))
                continue
            if batch:                     # flush staged chunks: ONE enter
                outstanding = batch
                batch = []
                while outstanding:
                    reqs = []
                    chunk_of: Dict[int, tuple] = {}   # ud -> (dst, nb)
                    for dst, nb in outstanding:
                        membytes = nb if zc else 3 * nb  # DMA (+bounce)
                        self._charge(src, core, 0.0, mem_bytes=membytes)
                        self.sent[src] += nb

                        def prep(sqe, ud, dst=dst, nb=nb):
                            prep_send(sqe, dst, nb, zero_copy=zc)
                            chunk_of[ud] = (dst, nb)
                        reqs.append(IoRequest(prep))
                    cqes = yield reqs
                    outstanding = []
                    for c in cqes:
                        dst, nb = chunk_of[c.user_data]
                        if c.res < 0:     # link flap: chunk went nowhere
                            self.send_errors += 1
                            self.sent[src] -= nb       # not delivered
                            outstanding.append((dst, nb))
                            continue
                        if c.flags & CqeFlags.MORE:   # zc: notif pending
                            pending_notifs.append(c.user_data)
                    if outstanding:       # wait out the flap, re-send
                        self.resends += 1
                        dt = (self.faults.spec.flap_duration
                              if self.faults is not None else 200e-6)
                        yield IoRequest(lambda sqe, _ud, dt=dt:
                                        prep_timeout(sqe, dt))
                while len(pending_notifs) > max_pinned:
                    yield StreamRead(pending_notifs.popleft())
            if ev[0] == "morsel":
                _, nb, n_tuples, local = ev
                cpu = nb * cfg.scan_cost_per_byte + \
                    n_tuples * cfg.partition_cost_per_tuple
                self._charge(src, core, cpu, mem_bytes=nb)
                if cfg.build_probe_table and local:
                    lt = local // cfg.tuple_size
                    self._charge(src, core, lt * cfg.dram_stall_s,
                                 mem_bytes=lt * 64)
        while pending_notifs:             # release remaining zc buffers
            yield StreamRead(pending_notifs.popleft())

    def _receiver(self, dst: int, src: int):
        """Drain one inbound flow; multishot recv + provided buffers
        (io_uring) or single-shot recv per chunk (epoll baseline)."""
        cfg = self.cfg
        w = receiver_worker(cfg, dst, src)
        slot = self._slot(dst, w)
        core, ring = self.cores[slot], self.rings[slot]
        expect = self.expected.get((src, dst), 0)
        got = 0
        zc = cfg.zc_recv
        if cfg.iface == "epoll":
            while got < expect:
                def prep(sqe, ud):
                    prep_recv(sqe, src, 0)
                cqe = yield IoRequest(prep)
                if cqe.res < 0:           # link flap: re-issue the recv
                    self.conn_resets += 1
                    continue
                assert cqe.res > 0, f"recv failed: {cqe.res}"
                got += cqe.res
                self._consume(dst, core, cqe.res)
            return
        bgid = src
        bring = ring.register_buf_ring(bgid, cfg.rx_buffers,
                                       cfg.chunk_bytes)
        ud = None
        while got < expect:
            if ud is None:                # (re-)arm the multishot recv
                def prep(sqe, _ud):
                    prep_recv(sqe, src, 0, zero_copy=zc, buf_group=bgid,
                              flags=(SqeFlags.MULTISHOT |
                                     SqeFlags.POLL_FIRST))
                ud = yield IoRequest(prep, multishot=True)
            cqe = yield StreamRead(ud)
            if cqe.res == EAGAIN and not (cqe.flags & CqeFlags.MORE):
                # buffer ring ran dry: wait until the queued probe work
                # completes (every pending recycle fires by then), then
                # re-arm — a real engine polls/waits the same way
                # instead of spinning on EAGAIN
                dt = max(core.free - self.tl.now, 1e-9)
                yield IoRequest(lambda sqe, _ud, dt=dt:
                                prep_timeout(sqe, dt))
                ud = None
                continue
            if cqe.res < 0:               # reset: re-arm the multishot
                self.conn_resets += 1     # (no provided buffer consumed)
                ud = None
                continue
            assert cqe.res > 0, f"recv failed: {cqe.res}"
            got += cqe.res
            t_done = self._consume(dst, core, cqe.res)
            if cqe.buf_id >= 0:
                # the buffer stays occupied until the probe work has
                # actually run in virtual time, not when this fiber is
                # scheduled — occupancy is what exhausts the ring
                self.tl.at(t_done, lambda bid=cqe.buf_id:
                           bring.recycle(bid))
            if not (cqe.flags & CqeFlags.MORE):
                ud = None
        if ud is not None:
            yield StreamClose(ud)

    def _consume(self, node: int, core: CoreClock, nb: int) -> float:
        """Receive-side tuple work: probe-table build + memory traffic
        (the kernel->user copy CPU was already charged by the ring).
        Returns the virtual time the chunk is fully processed."""
        cfg = self.cfg
        self.received[node] += nb
        membytes = nb + (0 if cfg.zc_recv else 2 * nb)
        cpu = 0.0
        if cfg.build_probe_table:
            n_tuples = nb // cfg.tuple_size
            cpu += n_tuples * (cfg.dram_stall_s +
                               cfg.partition_cost_per_tuple)
            membytes += n_tuples * 64
        return self._charge(node, core, cpu, mem_bytes=membytes)

    # ---------------------------------------------------------- metrics

    def register_metrics(self, reg, prefix: str = "shuffle") -> None:
        """Shuffle stat surface for the telemetry sampler.  Aggregated
        across all ``n_nodes × n_workers`` rings (per-ring series would
        be up to 192 of them); pure reads only."""
        base = reg.unique(prefix)
        rs = self.rings

        def rsum(attr):
            return lambda: sum(getattr(r.stats, attr) for r in rs)

        reg.counter(f"{base}/sent_bytes", lambda: sum(self.sent),
                    unit="bytes")
        reg.counter(f"{base}/received_bytes",
                    lambda: sum(self.received), unit="bytes")
        reg.counter(f"{base}/enters", rsum("enters"))
        reg.counter(f"{base}/multishot_cqes", rsum("multishot_recv_cqes"))
        reg.counter(f"{base}/zc_notifs", rsum("zc_notifs"))
        reg.counter(f"{base}/buf_ring_exhausted",
                    rsum("buf_ring_exhausted"))
        reg.counter(f"{base}/bounce_bytes", rsum("bounce_bytes_copied"),
                    unit="bytes")
        reg.wrate(f"{base}/batch_eff", rsum("sqes_submitted"),
                  rsum("enters"), unit="sqe/enter")
        reg.wrate(f"{base}/egress_gib_s",
                  lambda: sum(self.sent) / 2**30, None, unit="GiB/s")
        reg.wgroup(f"{base}/attr", self._merged_attribution,
                   lambda: sum(r.stats.cpu_seconds_app +
                               r.stats.cpu_seconds_sqpoll for r in rs))

    # -------------------------------------------------------------- run

    def run(self) -> Dict:
        from repro_torch.observe import metrics as _metrics
        if _metrics.CURRENT is not None:
            self.register_metrics(_metrics.CURRENT)
        cfg = self.cfg
        n = cfg.n_nodes
        for node in range(n):
            for w in range(cfg.n_workers):
                slot = self._slot(node, w)
                self.cores[slot].name = f"shuf-n{node}w{w}"
                self.sched.spawn(self._sender(node, w),
                                 core=slot, ring=slot,
                                 name=f"shuf-send-n{node}w{w}")
            for p in range(n):
                if p == node:
                    continue
                slot = self._slot(node, receiver_worker(cfg, node, p))
                self.sched.spawn(self._receiver(node, p),
                                 core=slot, ring=slot,
                                 name=f"shuf-recv-n{node}<-n{p}")
        self.sched.run()
        assert sum(self.sent) == sum(self.received), "bytes lost in flight"

        dur = max([self.tl.now] + [c.free for c in self.cores] +
                  self.mem_free + [1e-9])
        enters = sum(r.stats.enters for r in self.rings)
        sqes = sum(r.stats.sqes_submitted for r in self.rings)
        ring_cpu = sum(r.stats.cpu_seconds_app for r in self.rings)
        egress = [s / dur for s in self.sent]
        out = {
            "duration_s": dur,
            "egress_gib_per_node": sum(egress) / n / 2**30,
            "egress_gbit_per_node": sum(egress) / n * 8 / 1e9,
            "mem_gib_s": sum(self.mem_bytes) / n / dur / 2**30,
            "mem_per_net_byte": (sum(self.mem_bytes) /
                                 max(1, sum(self.sent) +
                                     sum(self.received))),
            # acceptance: syscalls are MEASURED ring enters, not a model
            "syscalls": enters,
            "cpu_busy_frac": (sum(self.cpu_busy_app) + ring_cpu) /
                             (n * cfg.n_workers * dur),
            "enters": enters,
            "sqes_submitted": sqes,
            "batch_eff": sqes / max(1, enters),
            "multishot_cqes": sum(r.stats.multishot_recv_cqes
                                  for r in self.rings),
            "zc_notifs": sum(r.stats.zc_notifs for r in self.rings),
            "buf_ring_exhausted": sum(r.stats.buf_ring_exhausted
                                      for r in self.rings),
            "bounce_bytes": sum(r.stats.bounce_bytes_copied
                                for r in self.rings),
            "app_cpu_s": ring_cpu,
            "sqpoll_cpu_s": sum(r.stats.cpu_seconds_sqpoll
                                for r in self.rings),
            "sends_copied": sum(r.stats.sends_copied for r in self.rings),
            "send_bytes_copied": sum(r.stats.send_bytes_copied
                                     for r in self.rings),
            "attribution": self._merged_attribution(),
        }
        if self.faults is not None:
            out.update({
                "faults_injected": self.faults.total_injected,
                "send_errors": self.send_errors,
                "resends": self.resends,
                "conn_resets": self.conn_resets,
            })
        return out

    def _merged_attribution(self) -> Dict[str, float]:
        attr: Dict[str, float] = {}
        for r in self.rings:
            for k, v in r.stats.attribution.items():
                attr[k] = attr.get(k, 0.0) + v
        return attr
