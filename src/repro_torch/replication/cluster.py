"""Primary→standby wiring: one timeline, one scheduler, two nodes.

``ReplicatedCluster`` builds the primary ``StorageEngine`` from an
``EngineConfig`` whose ``repl`` field names the rung, then:

* creates a 2-node ``SimNetwork`` with a ship socket (primary→standby
  WAL stream) and an ack socket (standby→primary), registered as fds on
  each node's own ring;
* builds the ``StandbyNode`` (its ring joins the primary's scheduler via
  ``FiberScheduler.attach_ring`` — storage and network I/O of BOTH nodes
  run on one deterministic event loop, the paper's unified-interface
  thesis end-to-end);
* installs itself as ``engine.repl``: ``run_fibers`` spawns the
  replication fibers next to the workers, and the commit path calls
  ``wait_commit`` — which returns immediately (``async``), waits for the
  standby's WAL-durable ack (``semisync``) or for the standby's applied
  ack (``sync``).

A plain ``StorageEngine`` (``repl="off"`` or built directly) never sees
any of this — the single-node path is bit-for-bit unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.core import NVMeSpec
from repro_torch.core.backends import NICSpec, SimNetwork, SimSocket
from repro_torch.core.fibers import Gate, IoRequest, StreamClose, StreamRead
from repro_torch.core.ring import prep_recv, prep_timeout
from repro_torch.core.sqe import EAGAIN, CqeFlags, SqeFlags
from repro_torch.replication.frames import FrameAssembler, FrameKind
from repro_torch.replication.sender import LogSender
from repro_torch.replication.standby import StandbyNode
from repro_torch.storage.engine import (DATA_FD, LOG_FD, EngineConfig,
                                        StorageEngine)

SHIP_FD = 8          # primary -> standby WAL stream
ACK_FD = 9           # standby -> primary acks
ACK_BGID = 12        # provided buffer ring for ack recv on the primary

MODES = ("async", "semisync", "sync")


class ReplicatedCluster:
    """One primary + one warm standby on a shared event loop."""

    def __init__(self, cfg: EngineConfig, *, n_tuples: int = 200_000,
                 spec: Optional[NVMeSpec] = None, seed: int = 0,
                 nic: Optional[NICSpec] = None, chunk_bytes: int = 4096,
                 rx_buffers: int = 64, zc_ship: str = "auto",
                 ack_timeout: Optional[float] = None):
        assert cfg.repl in MODES, \
            f"EngineConfig.repl must be one of {MODES}, got {cfg.repl!r}"
        assert cfg.durability != "none", "log shipping needs a WAL rung"
        self.cfg = cfg
        self.mode = cfg.repl
        self.primary = StorageEngine(cfg, n_tuples=n_tuples, spec=spec,
                                     seed=seed)
        p = self.primary
        self.nic = nic or NICSpec()
        self.net = SimNetwork(p.tl, 2, self.nic)
        ship_p, ship_s = SimSocket.pair(self.net, 0, 1)
        ack_s, ack_p = SimSocket.pair(self.net, 1, 0)
        p.ring.register_device(SHIP_FD, ship_p)
        p.ring.register_device(ACK_FD, ack_p)
        self.standby = StandbyNode(p, ship_s, ack_s, data_fd=DATA_FD,
                                   log_fd=LOG_FD, ship_fd=SHIP_FD,
                                   ack_fd=ACK_FD, chunk_bytes=chunk_bytes,
                                   rx_buffers=rx_buffers)
        s = self.standby
        if p.mc:
            idx = p.sched.attach_ring(s.ring, core=s.core)
            s.ring_idx, s.core_idx = idx, idx
        else:
            s.ring_idx = p.sched.attach_ring(s.ring)
            s.core_idx = 0
        self.sender = LogSender(
            p, SHIP_FD, chunk_bytes=chunk_bytes, zc_ship=zc_ship,
            zc_threshold=self.nic.zc_send_threshold)
        # reconnect policy: after a link flap the sender resumes from
        # the standby's acked durable horizon (everything past it may
        # have died on the wire); the standby slices the overlap
        self.sender.resume_from = lambda: self.acked_durable
        # fault plane: the engine owns ONE plane (EngineConfig.faults);
        # the link sockets consult the same plane so all fault rolls
        # stay in one deterministic event-order RNG stream.  Faults
        # roll on the SENDING end: ship_p is the primary's ship socket,
        # ack_s the standby's ack socket.
        fp = getattr(p, "faults", None)
        if fp is not None:
            ship_p.faults = fp
            ack_s.faults = fp
        self._ship_sock = ship_p
        self._ack_sock = ack_s
        self.ack_gate = Gate(p.sched)
        self.acked_durable = 0
        self.acked_applied = 0
        self.acks = 0
        self.fin = False
        # semisync degrade: if the standby's durable ack makes no
        # progress for ack_timeout seconds while commits wait, drop to
        # async (stop gating commits) rather than stall the primary;
        # re-promote once the ack horizon catches back up.  None (the
        # default) disables the watchdog entirely — existing semisync
        # runs are bit-identical.
        self.ack_timeout = ack_timeout
        self.degraded = False
        self.degrades = 0
        self.repromotions = 0
        self.ack_resets = 0           # resets seen on the ack stream
        self._last_progress = p.tl.now
        p.repl = self

    # ------------------------------------------------- engine-side hooks

    def ship_horizon(self) -> int:
        """Replication-slot bound for WAL truncation: everything at or
        above this LSN is still needed by the ship stream."""
        return self.sender.shipped

    def wait_commit(self, lsn: int):
        """Fiber generator run inside ``StorageEngine.commit`` after
        local durability: the replication rung's commit gate.  A
        DEGRADED semisync cluster acks like async — the txn is locally
        durable and the standby will catch up from the ship stream."""
        if self.mode == "async":
            return
        while True:
            if self.degraded and self.mode == "semisync":
                return
            have = self.acked_applied if self.mode == "sync" \
                else self.acked_durable
            if have >= lsn:
                return
            yield self.ack_gate

    def spawn_fibers(self, workers) -> None:
        """Called by ``run_fibers``: the replication fiber complement.
        All primary-side fibers live on core 0 / ring 0 (SINGLE_ISSUER:
        the sender shares the WAL leader's ring); the standby's live on
        its own attached ring."""
        p, s = self.primary, self.standby
        stop = lambda: all(f.done for f in workers)       # noqa: E731
        from repro_torch.observe import metrics as _metrics
        if _metrics.CURRENT is not None:
            self.register_metrics(_metrics.CURRENT)
        p.sched.spawn(self.sender.run(stop), core=0, ring=0,
                      name="repl-sender")
        p.sched.spawn(self._ack_receiver(), core=0, ring=0,
                      name="repl-ack-recv")
        p.sched.spawn(self._watcher(stop), core=0, ring=0,
                      name="repl-watcher")
        if self.mode == "semisync" and self.ack_timeout is not None:
            p.sched.spawn(self._degrade_watchdog(), core=0, ring=0,
                          name="repl-degrade-watchdog")
        p.sched.spawn(s.receiver(), core=s.core_idx, ring=s.ring_idx,
                      name="standby-receiver")
        p.sched.spawn(s.flusher(), core=s.core_idx, ring=s.ring_idx,
                      name="standby-flusher")
        p.sched.spawn(s.applier(), core=s.core_idx, ring=s.ring_idx,
                      name="standby-applier")

    def _watcher(self, stop):
        """Wakes the (gate-parked) sender when the workload quiesces —
        the last flush hook may fire before the last worker is marked
        done, so someone must deliver the shutdown edge."""
        while not stop():
            yield None
        self.sender.gate.open()

    def _degrade_watchdog(self):
        """Semisync availability policy: tick every ack_timeout/4 (one
        TIMEOUT SQE per tick, ETIME = timer fired); if the durable-ack
        horizon has not advanced for ack_timeout while commits are
        waiting on it, DEGRADE to async acking and wake the waiters.
        Once the standby catches the primary's durable horizon back up,
        re-promote to semisync.  Both edges are counted and surfaced to
        the advisor."""
        p = self.primary
        tick = self.ack_timeout / 4

        def prep(sqe, ud, d=tick):
            prep_timeout(sqe, d)
        while not self.fin:
            yield IoRequest(prep)
            lagging = p.wal.durable_lsn > self.acked_durable
            if not self.degraded:
                if lagging and (p.tl.now - self._last_progress
                                > self.ack_timeout):
                    self.degraded = True
                    self.degrades += 1
                    self.ack_gate.open()       # release parked commits
            elif not lagging:
                self.degraded = False
                self.repromotions += 1

    def _ack_receiver(self):
        """Multishot recv over the ack socket (provided buffer ring —
        acks are tiny and batched by the standby per flush/apply)."""
        ring = self.primary.ring
        bring = ring.register_buf_ring(ACK_BGID, 32, 64)
        asm = FrameAssembler()
        ud = None
        while not self.fin:
            if ud is None:
                def prep(sqe, _ud):
                    prep_recv(sqe, ACK_FD, 0, buf_group=ACK_BGID,
                              flags=(SqeFlags.MULTISHOT |
                                     SqeFlags.POLL_FIRST))
                ud = yield IoRequest(prep, multishot=True)
            cqe = yield StreamRead(ud)
            if cqe.res == EAGAIN and not (cqe.flags & CqeFlags.MORE):
                ud = None
                continue
            if cqe.res < 0:
                # ack-link reset: drop the torn ack (acks are
                # cumulative, the next one supersedes it) and re-arm
                self.ack_resets += 1
                asm.reset()
                ud = None
                continue
            data = bytes(bring.buffers[cqe.buf_id][:cqe.res])
            bring.recycle(cqe.buf_id)
            for fr in asm.feed(data):
                assert fr.kind == FrameKind.ACK
                if fr.lsn_lo > self.acked_durable:
                    self._last_progress = self.primary.tl.now
                self.acked_durable = max(self.acked_durable, fr.lsn_lo)
                self.acked_applied = max(self.acked_applied, fr.lsn_hi)
                self.acks += 1
                if fr.payload:                   # fin marker
                    self.fin = True
            self.ack_gate.open()
            if not (cqe.flags & CqeFlags.MORE):
                ud = None
        if ud is not None:
            yield StreamClose(ud)
        self.ack_gate.open()

    # ------------------------------------------------------------- runs

    def run(self, make_txn, n_txns: int) -> Dict:
        """The normal benchmark entry point: run the workload on the
        primary; replication fibers ride along automatically."""
        return self.primary.run_fibers(make_txn, n_txns)

    def crash_run(self, fibers: List, *, steps: int) -> List:
        """Spawn the given workload fiber generators plus the
        replication complement, run the cluster for a bounded number of
        scheduler decisions, then pull the plug mid-flight (frames may
        be torn on the wire, spans half-flushed, applies half-done).
        Returns the worker fibers for inspection."""
        p = self.primary
        workers = [p.sched.spawn(g) for g in fibers]
        self.spawn_fibers(workers)
        budget = {"left": steps}

        def out_of_budget():
            budget["left"] -= 1
            return budget["left"] <= 0
        p.sched.run(until=out_of_budget)
        return workers

    # ------------------------------------------------------------ stats

    def register_metrics(self, reg, prefix: str = "repl") -> None:
        """Replication stat surface for the telemetry sampler: durable
        and apply lag gauges (primary durable LSN minus the standby's
        durable/applied horizon), ship-stream counters, and the
        standby ring's own surface.  Pure reads — registration must
        not change scheduling (observer effect = zero)."""
        p, s = self.primary, self.standby
        base = reg.unique(prefix)
        reg.gauge(f"{base}/durable_lag_b",
                  lambda: p.wal.durable_lsn - s.wal.durable_lsn,
                  unit="bytes")
        reg.gauge(f"{base}/apply_lag_b",
                  lambda: p.wal.durable_lsn - s.applied_lsn,
                  unit="bytes")
        reg.counter(f"{base}/acks", lambda: self.acks)
        reg.counter(f"{base}/ship_frames", lambda: self.sender.frames)
        reg.counter(f"{base}/ship_chunks", lambda: self.sender.chunks)
        reg.counter(f"{base}/ship_bytes",
                    lambda: self.sender.ship_bytes, unit="bytes")
        reg.counter(f"{base}/standby_commits",
                    lambda: len(s.commits))
        reg.counter(f"{base}/reconnects",
                    lambda: self.sender.reconnects)
        reg.counter(f"{base}/send_errors",
                    lambda: self.sender.send_errors)
        reg.counter(f"{base}/conn_resets", lambda: s.conn_resets)
        reg.counter(f"{base}/semisync_degrades", lambda: self.degrades)
        reg.counter(f"{base}/repromotions",
                    lambda: self.repromotions)
        reg.gauge(f"{base}/degraded",
                  lambda: 1 if self.degraded else 0)
        s.ring.register_metrics(reg, f"{base}/standby_ring")

    def result_rows(self) -> Dict:
        p, s = self.primary, self.standby
        lag_b = [b for _, b, _ in s.lag_samples]
        alag_b = [b for _, _, b in s.lag_samples]
        return {
            "repl_mode": self.mode,
            "acks": self.acks,
            "ship_frames": self.sender.frames,
            "ship_chunks": self.sender.chunks,
            "ship_zc_chunks": self.sender.zc_chunks,
            "ship_mb": self.sender.ship_bytes / 1e6,
            "standby_commits": len(s.commits),
            "standby_durable_lag_b": (p.wal.durable_lsn -
                                      s.wal.durable_lsn),
            "standby_apply_lag_b": p.wal.durable_lsn - s.applied_lsn,
            "mean_apply_lag_b": (sum(alag_b) / len(alag_b)
                                 if alag_b else 0.0),
            "max_durable_lag_b": max(lag_b) if lag_b else 0,
            "standby_cpu_s": s.ring.stats.cpu_seconds_app,
            # fault plane / recovery surfaces
            "repl_reconnects": self.sender.reconnects,
            "repl_send_errors": self.sender.send_errors,
            "sock_resets": (self._ship_sock.resets +
                            self._ack_sock.resets),
            "standby_conn_resets": s.conn_resets,
            "dup_spans": s.dup_spans,
            "overlap_spans": s.overlap_spans,
            "semisync_degrades": self.degrades,
            "repromotions": self.repromotions,
        }


def replicated_workload_state(cluster: ReplicatedCluster):
    """Convenience for tests/benches: (committed txn ids in ack order,
    primary last-writer map, standby last-writer map)."""
    return (list(cluster.primary.committed),
            dict(cluster.primary.last_writer),
            dict(cluster.standby.last_writer))
