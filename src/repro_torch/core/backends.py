"""Device backends for the ring runtime.

``SimNVMe`` / ``SimNIC`` model the paper's hardware (Kioxia CM7-R array,
ConnectX-7 400G) with the latency/bandwidth constants the paper measures;
``FileBackend`` does real file I/O (used by the framework's own data
pipeline and checkpointing with a RealClock ring).

A backend's ``submit`` classifies each op onto one of the paper's three
execution paths (Fig. 3):
  ("inline", result)              — completed during submission
  ("async", completion_time, res) — poll-set / device completion
  ("worker", device_time, res)    — blocking fallback via io_worker
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from repro_torch.core.sqe import SQE, Op, SqeFlags, EAGAIN, EINVAL, EIO, \
    ENOTSUP, ETIME

KiB = 1024
MiB = 1024 * KiB

# ---------------------------------------------------------------------------
# Named device-registration slots
# ---------------------------------------------------------------------------
# Every subsystem registers its backing device on the ring under a fixed
# NAMED fd, so traces and bench rows stay readable and no two subsystems
# collide on a magic number (the KV pager used to hard-code "5").  The
# storage engine re-exports DATA_FD/LOG_FD; the serving tier uses the
# KV_* slots.

DATA_FD = 3        # B-tree data file (repro.storage.engine)
LOG_FD = 4         # WAL log device (repro.wal)
KV_HOST_FD = 5     # serving tier: host-DRAM KV spill store
KV_NVME_FD = 6     # serving tier: NVMe cold tier (raw namespace)
LSM_FD = 7         # LSM SSTable store (repro.lsm)


def host_dram_spec() -> "NVMeSpec":
    """The serving tier's host-DRAM spill store: CXL/NUMA-interleaved
    DRAM reached through the ring — microsecond latency, memory-class
    bandwidth.  A factory (specs are mutable dataclasses): every pager
    gets its own instance."""
    return NVMeSpec(read_lat=1.5e-6, write_lat=1.0e-6,
                    n_ssds=4, iops_per_ssd=1e7,
                    read_bw=50e9, write_bw=50e9)


def kv_nvme_spec() -> "NVMeSpec":
    """The serving tier's cold tier: the paper's Kioxia CM7-R array at
    its Table 1 constants (the same device the storage engine runs on)."""
    return NVMeSpec()


# ---------------------------------------------------------------------------
# Simulated NVMe SSD array (paper §3, Table 1/2, Fig. 7/8)
# ---------------------------------------------------------------------------

@dataclass
class NVMeSpec:
    read_lat: float = 70e-6          # 4 KiB random read (Table 1)
    write_lat: float = 12e-6         # 4 KiB random write (Table 1)
    n_ssds: int = 8
    iops_per_ssd: float = 2.45e6     # Kioxia CM7-R
    read_bw: float = 11.5e9          # B/s per SSD  (array ~90 GiB/s reads)
    write_bw: float = 6.4e9          # B/s per SSD  (array ~50 GiB/s writes)
    # worker-fallback cliffs (paper Fig. 8)
    max_hw_sectors: int = 512 * KiB  # DMA limit (128 KiB w/ IOMMU)
    max_segments_bytes: int = 512 * KiB
    nr_requests: int = 1023
    fsync_lat: float = 1e-3          # consumer SSD; enterprise (PLP): ~5 µs
    plp: bool = True                 # enterprise: writes durable on arrival
    flush_lat: float = 5e-6          # NVMe flush w/ PLP


class SimNVMe:
    """An SSD array. Completion time = queue-aware latency model: each SSD
    services ops at iops rate; bursts grow the queue and the latency tail
    (reproduces Table 2)."""

    kind = "nvme"

    def __init__(self, timeline, spec: NVMeSpec = NVMeSpec(), *,
                 o_direct: bool = True, filesystem: bool = False):
        self.tl = timeline
        self.spec = spec
        self.o_direct = o_direct
        self.filesystem = filesystem   # blocks passthrough/IOPoll (GL4)
        self._next_free = [0.0] * spec.n_ssds
        self._rr = 0
        self.inflight = 0
        #: optional repro.core.faults.FaultPlane; None = no faults and
        #: zero per-op overhead (the hot path takes one attr load)
        self.faults = None

    def supports_iopoll(self) -> bool:
        return self.o_direct and not self.filesystem

    def supports_passthrough(self) -> bool:
        return not self.filesystem

    def _ssd_for(self, offset: int) -> int:
        return (offset // (4 * KiB)) % self.spec.n_ssds

    # content hooks (timing-only by default; SimDisk stores real bytes)
    def content_read(self, offset: int, buf, length: int) -> None:
        pass

    def content_write(self, offset: int, buf, length: int) -> None:
        pass

    # fsync-epoch hooks: SimDisk models the fsyncgate semantics (a
    # failed fsync DROPS the dirty page cache — the data is gone until
    # rewritten); timing-only devices need no state.
    def _fsync_ok(self) -> None:
        pass

    def _fsync_failed(self) -> None:
        pass

    def service(self, sqe: SQE) -> Tuple[str, float, int]:
        sp = self.spec
        fp = self.faults
        now = self.tl.now
        n = max(1, sqe.length)
        write = sqe.op in (Op.WRITEV, Op.WRITE_FIXED)
        # NVMe passthrough faults: the uring-cmd path can hit an
        # unsupported command (-ENOTSUP) or hang until the driver's
        # command timeout (-ETIME); callers degrade to the regular path
        if fp is not None and (sqe.op == Op.URING_CMD
                               or sqe.cmd is not None):
            if fp.roll("passthru_enotsup", now):
                return ("async", 1e-6, ENOTSUP)
            if fp.roll("passthru_timeout", now):
                base = sp.flush_lat if sqe.op == Op.FSYNC \
                    else (sp.write_lat if write else sp.read_lat)
                return ("async", base * fp.spec.spike_factor, ETIME)
        if sqe.op == Op.FSYNC:
            lat = sp.flush_lat if (sp.plp and sqe.cmd == "nvme-flush") \
                else sp.fsync_lat
            path = "worker" if sqe.cmd != "nvme-flush" else "async"
            if fp is not None and fp.roll("fsync_fail", now):
                self._fsync_failed()
                return (path, lat, EIO)
            self._fsync_ok()
            return (path, lat, 0)
        # worker-fallback cliffs (Fig. 8)
        if n > sp.max_hw_sectors or n > sp.max_segments_bytes:
            path = "worker"
        elif self.o_direct and self.inflight >= sp.nr_requests:
            path = "worker"
        else:
            path = "async"
        ssd = self._ssd_for(sqe.offset)
        base = sp.write_lat if write else sp.read_lat
        bw = sp.write_bw if write else sp.read_bw
        xfer = n / bw
        svc = 1.0 / sp.iops_per_ssd
        t0 = max(self.tl.now, self._next_free[ssd])
        self._next_free[ssd] = t0 + max(svc, xfer)
        done = t0 + base + xfer
        res = n
        if fp is not None:
            # roll order is fixed (eio, then short, then spike) so the
            # same seed replays the same fault sequence
            if fp.roll("write_eio" if write else "read_eio", now):
                res = EIO
            elif n >= 2 and fp.roll(
                    "short_write" if write else "short_read", now):
                res = fp.short_len(n)
            if fp.roll("latency_spike", now):
                done = t0 + (base + xfer) * fp.spec.spike_factor
        return (path, done - self.tl.now, res)


class SimDisk(SimNVMe):
    """SimNVMe + an in-memory disk image, so the storage engine reads and
    writes REAL bytes (the B-tree lives on this "device") while timing
    follows the NVMe model."""

    def __init__(self, timeline, capacity: int,
                 spec: NVMeSpec = NVMeSpec(), **kw):
        super().__init__(timeline, spec, **kw)
        self.image = bytearray(capacity)
        # fsyncgate model (only active with a fault plane attached):
        # pre-images of every span written since the last *successful*
        # fsync, applied in reverse on a failed fsync — a failed fsync
        # means the page cache dropped the dirty data, so a naive
        # "just fsync again" retry silently loses the writes.  The
        # correct recovery (wal/log.py) re-WRITES the span first.
        self._unsynced: list = []

    #: bound on tracked pre-images; overflow drops the oldest (those
    #: writes "made it to media anyway" — fsync failure never
    #: *guarantees* loss).  Keeps devices that are never fsynced (the
    #: data disk under WAL-before-data) from accumulating state.
    MAX_UNSYNCED = 4096

    def content_read(self, offset: int, buf, length: int) -> None:
        if buf is not None:
            buf[:length] = self.image[offset:offset + length]

    def content_write(self, offset: int, buf, length: int) -> None:
        if buf is not None:
            if self.faults is not None:
                if len(self._unsynced) >= self.MAX_UNSYNCED:
                    del self._unsynced[0]
                self._unsynced.append(
                    (offset, bytes(self.image[offset:offset + length])))
            self.image[offset:offset + length] = bytes(buf[:length])

    def _fsync_ok(self) -> None:
        self._unsynced.clear()

    def _fsync_failed(self) -> None:
        for offset, pre in reversed(self._unsynced):
            self.image[offset:offset + len(pre)] = pre
        self._unsynced.clear()


# ---------------------------------------------------------------------------
# Simulated NIC / network (paper §4, Fig. 11–16)
# ---------------------------------------------------------------------------

@dataclass
class NICSpec:
    bw: float = 50e9                 # 400 Gbit/s = 50 GB/s each direction
    base_lat: float = 9e-6           # one-way small-message latency
    zc_send_threshold: int = 1 * KiB  # below: zero-copy loses (Fig. 16)
    zc_recv_threshold: int = 1 * KiB
    untuned_factor: float = 0.75     # Fig. 14: flow imbalance on an
                                     # untuned qdisc/socket-buffer stack


class SimNetwork:
    """A cluster of nodes with full-duplex links; ``SimSocket`` endpoints
    are created in connected pairs.

    Pacing model (paper §4.4, Fig. 14): the sender's NIC is one tx lane
    at the full link rate; the receive side is a *fair-share* lane per
    (dst, src) flow at ``bw / (n_nodes - 1)`` — TCP fairness across the
    all-to-all mesh, which the paper's qdisc/socket-buffer tuning is
    what makes fair.  An untuned stack loses ``1 - untuned_factor`` of
    effective bandwidth to flow imbalance.  ``flow_schedule`` is pure
    clock arithmetic over explicit start times, so the analytical
    shuffle oracle (``shuffle.sim``) and the ring runtime's
    ``SimSocket`` share one link model."""

    def __init__(self, timeline, n_nodes: int, spec: NICSpec = NICSpec(),
                 *, tuned: bool = True):
        self.tl = timeline
        self.n_nodes = n_nodes
        self.spec = spec
        self.tuned = tuned
        self.tx_free = [0.0] * n_nodes
        self.rx_flow_free: Dict[Tuple[int, int], float] = {
            (d, s): 0.0 for d in range(n_nodes) for s in range(n_nodes)}

    def effective_bw(self) -> float:
        return self.spec.bw * (1.0 if self.tuned
                               else self.spec.untuned_factor)

    def flow_schedule(self, src: int, dst: int, nbytes: int,
                      t_start: float) -> Tuple[float, float]:
        """Pace one transfer; returns ``(t_tx_done, t_arrive)``.

        ``t_tx_done`` is when the sender NIC has drained the buffer
        (SEND_ZC buffer release); ``t_arrive`` is when the last byte is
        available at the receiver."""
        bw = self.effective_bw()
        tx0 = max(t_start, self.tx_free[src])
        self.tx_free[src] = tx0 + nbytes / bw
        flow_bw = bw / max(1, self.n_nodes - 1)
        rx0 = max(self.rx_flow_free[(dst, src)], tx0)
        self.rx_flow_free[(dst, src)] = rx0 + nbytes / flow_bw
        return self.tx_free[src], \
            self.rx_flow_free[(dst, src)] + self.spec.base_lat

    def xfer_time(self, src: int, dst: int, nbytes: int) -> float:
        """Delay from now until arrival (legacy single-transfer API)."""
        _, arrive = self.flow_schedule(src, dst, nbytes, self.tl.now)
        return arrive - self.tl.now


class SimSocket:
    """One endpoint of a connected pair over a SimNetwork.

    The timing plane moves message *sizes* (``rx_queue``); an optional
    data plane carries the actual payload bytes alongside (``rx_data``),
    so protocols that must reconstruct state at the receiver — WAL log
    shipping, replication acks — move real bytes while sharing the link
    model with size-only users (the shuffle sends no payloads and pays
    nothing).  Payload content is captured at submission time; the
    zero-copy no-reuse-before-ZC_NOTIF discipline is the sender's
    responsibility, exactly as on a real NIC."""

    kind = "socket"

    #: rx_queue sentinel for a connection reset: the peer's (multishot)
    #: recv completes with -ECONNRESET instead of data, exactly like a
    #: TCP RST surfacing on a real ring.  Delivered IN ORDER relative
    #: to data, so the receiver knows every byte before the marker
    #: arrived and every byte after it belongs to the new connection.
    RESET = -1

    def __init__(self, net: SimNetwork, node: int, peer_node: int):
        self.net = net
        self.node = node
        self.peer_node = peer_node
        self.peer: Optional["SimSocket"] = None
        self.rx_queue: list = []          # nbytes per delivered message
        self.rx_data: list = []           # parallel payloads (bytes|None)
        self.rx_waiters: list = []
        self.last_payload: Optional[bytes] = None   # of last try_recv()
        #: optional repro.core.faults.FaultPlane (sender-side): rolls
        #: sock_reset per send; a hit breaks the link for
        #: flap_duration and delivers a RESET marker to the peer
        self.faults = None
        self.broken_until = 0.0
        self.resets = 0

    @staticmethod
    def pair(net: SimNetwork, a: int, b: int):
        sa, sb = SimSocket(net, a, b), SimSocket(net, b, a)
        sa.peer, sb.peer = sb, sa
        return sa, sb

    def service_send(self, nbytes: int, t_start: Optional[float] = None,
                     payload: Optional[bytes] = None) -> Tuple[float, float]:
        """Pace the transfer from ``t_start`` (default: now) and schedule
        delivery at the peer; returns absolute ``(t_tx_done, t_arrive)``.
        ``t_tx_done`` is when the NIC has drained the send buffer — the
        SEND_ZC notification point."""
        if t_start is None:
            t_start = self.net.tl.now
        tx_done, arrive = self.net.flow_schedule(
            self.node, self.peer_node, nbytes, t_start)
        peer = self.peer

        def deliver():
            peer.rx_queue.append(nbytes)
            peer.rx_data.append(payload)
            for w in peer.rx_waiters[:]:
                w()
        self.net.tl.at(arrive, deliver)
        return tx_done, arrive

    def send_faulted(self, t: float) -> bool:
        """Consult the fault plane for one send issued at ``t``.

        True means the send fails with -ECONNRESET and delivers
        nothing (atomic per message — a failed chunk never partially
        arrives, mirroring TCP's all-or-nothing segment delivery into
        the stream).  The first failing send of a flap breaks the link
        until ``broken_until`` and schedules a RESET marker at the
        peer; every send issued while broken also fails, so a batch
        of chunks fails as a contiguous suffix — the delivered prefix
        stays a valid stream prefix."""
        fp = self.faults
        if fp is None:
            return False
        if t < self.broken_until:
            fp.injected["sock_reset"] += 1
            return True
        if fp.roll("sock_reset", t):
            self.broken_until = t + fp.spec.flap_duration
            self.resets += 1
            peer = self.peer

            def deliver_reset():
                peer.rx_queue.append(self.RESET)
                peer.rx_data.append(None)
                for w in peer.rx_waiters[:]:
                    w()
            self.net.tl.at(t + self.net.spec.base_lat, deliver_reset)
            return True
        return False

    def try_recv(self) -> Optional[int]:
        if self.rx_queue:
            self.last_payload = self.rx_data.pop(0)
            return self.rx_queue.pop(0)
        return None

    def unrecv(self, nbytes: int) -> None:
        """Put the message just popped by ``try_recv`` back at the head
        of the queue (buffer-ring exhaustion: the recv terminates with
        EAGAIN and the message must not be lost)."""
        self.rx_queue.insert(0, nbytes)
        self.rx_data.insert(0, self.last_payload)


# ---------------------------------------------------------------------------
# Real file backend (RealClock rings: data pipeline / checkpointing)
# ---------------------------------------------------------------------------

class FileBackend:
    """Real pread/pwrite/fsync against the filesystem. With a virtual-clock
    ring this still works (the op executes immediately; only CPU cost is
    modeled), which keeps unit tests hermetic and fast."""

    kind = "file"

    def __init__(self, path: str, *, create: bool = False):
        flags = os.O_RDWR | (os.O_CREAT if create else 0)
        self.fd = os.open(path, flags, 0o644)
        self.path = path

    def close(self):
        os.close(self.fd)

    def pread(self, buf: memoryview, offset: int, length: int) -> int:
        data = os.pread(self.fd, length, offset)
        buf[:len(data)] = data
        return len(data)

    def pwrite(self, buf, offset: int, length: int) -> int:
        return os.pwrite(self.fd, bytes(buf[:length]), offset)

    def fsync(self) -> int:
        os.fsync(self.fd)
        return 0
