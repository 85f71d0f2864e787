"""The standby node: receive → persist → apply, all on its own ring.

Three fibers, pipelined like a real physical-replication standby:

* **receiver** — ONE multishot recv armed over the ship socket, backed
  by a provided buffer ring (paper §4.2: one SQE, a CQE per arriving
  chunk, zero re-arm syscalls; buffer-ring exhaustion terminates with
  EAGAIN and the fiber re-arms after recycling).  Chunks feed the
  ``FrameAssembler``; completed WAL_SPAN frames are appended verbatim
  to the standby's own WAL buffer (``append_raw`` — the two logs stay
  byte-identical, LSNs line up).
* **flusher** — makes received spans durable through the standby WAL's
  normal ``flush_to`` path (same Fig. 9 durability path as the
  primary's rung) and acks ``(durable_lsn, applied_lsn)`` back.  One
  ack per flush, not per commit — acks batch exactly like the commits
  they cover.
* **applier** — physiological redo of APPLY records (page-LSN guarded,
  the identical discipline to ``repro.wal.recovery`` pass 2) through
  the standby's buffer pool and B-tree, keeping a warm page image; acks
  the applied horizon for ``sync`` mode.  Per-key last-writer tracking
  is re-derived from COMMIT order on the wire and must match the
  primary's live map (tests assert it).

**Failover** (``promote``) runs the REAL recovery machinery
(``repro.wal.recovery.recover``) over the standby's own images with
``full_redo=True`` — the checkpoint redo bound is a promise about the
*primary's* disk, not ours.  ``point_in_time`` restores the base backup
plus a shipped-log prefix to any LSN.
"""

from __future__ import annotations

from typing import Dict, List, Set

from repro_torch.bufferpool import BufferPool, PoolConfig
from repro_torch.core import CoreClock, IoUring, SetupFlags
from repro_torch.core.backends import SimDisk, SimSocket
from repro_torch.core.fibers import Gate, IoRequest, StreamClose, StreamRead
from repro_torch.core.ring import prep_recv, prep_send, prep_timeout
from repro_torch.core.sqe import EAGAIN, CqeFlags, SqeFlags
from repro_torch.replication.frames import (FrameAssembler, FrameKind,
                                            encode_frame)
from repro_torch.storage.btree import BTree
from repro_torch.wal.log import (APPLY_IMG, BLOCK, LogHeader, RecordType,
                                 WriteAheadLog, _REC_HDR, decode_apply,
                                 decode_checkpoint, decode_kv)
from repro_torch.wal.recovery import _redo_upsert, recover

#: CPU cost of decoding + applying one APPLY record on the standby
#: (record parse + page touch; the page I/O itself is charged by the
#: standby's ring)
APPLY_CPU_S = 1.5e-6


class StandbyNode:
    """One warm standby fed by a ``LogSender`` on the primary."""

    RX_BGID = 11

    def __init__(self, primary, ship_sock: SimSocket,
                 ack_sock: SimSocket, *, data_fd: int, log_fd: int,
                 ship_fd: int, ack_fd: int, chunk_bytes: int = 4096,
                 rx_buffers: int = 64):
        cfg = primary.cfg
        tl = primary.tl
        self.primary = primary
        self.tl = tl
        self.cfg = cfg
        self.ship_fd = ship_fd
        self.ack_fd = ack_fd
        self.chunk_bytes = chunk_bytes
        self.rx_buffers = rx_buffers
        self.core = CoreClock()
        self.ring = IoUring(tl, sq_depth=512,
                            setup=(SetupFlags.SINGLE_ISSUER |
                                   SetupFlags.DEFER_TASKRUN),
                            core=self.core)
        # base backup: the standby starts from a copy of the primary's
        # data image (kept pristine for point-in-time restores)
        self.disk = SimDisk(tl, len(primary.disk.image),
                            spec=primary.disk.spec,
                            filesystem=primary.disk.filesystem)
        self.disk.image[:] = primary.disk.image
        self.base_image = bytes(primary.disk.image)
        self.log_disk = SimDisk(tl, cfg.log_capacity,
                                spec=primary.log_disk.spec,
                                filesystem=primary.log_disk.filesystem)
        self.ring.register_device(data_fd, self.disk)
        self.ring.register_device(log_fd, self.log_disk)
        self.ring.register_device(ship_fd, ship_sock)
        self.ring.register_device(ack_fd, ack_sock)
        hdr = primary.wal.header
        self.wal = WriteAheadLog(
            self.ring, log_fd, self.log_disk, mode=primary.wal.mode,
            header=LogHeader(hdr.root, hdr.next_pid, hdr.page_size,
                             hdr.value_size, hdr.data_capacity,
                             hdr.truncated_lsn))
        self.pool = BufferPool(self.ring, PoolConfig(
            n_frames=cfg.pool_frames, page_size=cfg.page_size,
            batch_evict=cfg.batch_evict, evict_batch=cfg.evict_batch,
            fixed_bufs=False, passthrough=cfg.passthrough, fd=data_fd))
        self.pool.wal = self.wal            # WAL-before-data holds here too
        self.tree = BTree(self.pool, primary.tree.root,
                          primary.tree.next_pid,
                          value_size=cfg.value_size)
        # set by ReplicatedCluster once the ring joins the scheduler
        self.sched = primary.sched
        self.ring_idx = -1
        self.core_idx = 0
        self.wal_gate = Gate(self.sched)    # receiver -> flusher
        self.apply_gate = Gate(self.sched)  # flusher  -> applier
        # progress
        self.applied_lsn = self.wal.end_lsn
        self._scan_off = self.wal.end_lsn
        self.shutdown = False
        self.flush_done = False
        self.commits: List[int] = []        # txn ids in COMMIT-LSN order
        self.last_writer: Dict[int, int] = {}
        self._intents: Dict[int, List[int]] = {}   # txn -> written keys
        self.applied_txns: Set[int] = set()        # APPLY_END seen
        self.spans_in = 0
        self.chunks_in = 0
        self.records_applied = 0
        self.pages_redone = 0
        self.pages_skipped = 0
        self.acks_sent = 0
        # error recovery (fault plane): connection resets seen on the
        # ship stream (assembler reset + multishot re-arm), re-shipped
        # spans that fully overlapped our log (dropped), spans sliced
        # to the fresh suffix, and ack sends lost to a flap (retried
        # until one lands — see _send_ack)
        self.conn_resets = 0
        self.dup_spans = 0
        self.overlap_spans = 0
        self.ack_send_errors = 0
        self.lag_samples: List[tuple] = []  # (t, durable_lag, apply_lag)

    # ------------------------------------------------------------ fibers

    def receiver(self):
        """Multishot recv + provided buffer ring over the ship socket."""
        bring = self.ring.register_buf_ring(self.RX_BGID, self.rx_buffers,
                                            self.chunk_bytes)
        asm = FrameAssembler()
        self.assembler = asm
        ud = None
        while not self.shutdown:
            if ud is None:                 # (re-)arm the multishot recv
                def prep(sqe, _ud):
                    prep_recv(sqe, self.ship_fd, 0,
                              buf_group=self.RX_BGID,
                              flags=(SqeFlags.MULTISHOT |
                                     SqeFlags.POLL_FIRST))
                ud = yield IoRequest(prep, multishot=True)
            cqe = yield StreamRead(ud)
            if cqe.res == EAGAIN and not (cqe.flags & CqeFlags.MORE):
                # ring ran dry while CQEs were queued behind us; every
                # buffer was recycled as we drained, so re-arm directly
                ud = None
                continue
            if cqe.res < 0:
                # connection reset: the torn frame head in the
                # assembler will never get its tail — drop it (the
                # primary re-ships the whole frame from our acked
                # horizon) and re-arm the multishot recv.  No provided
                # buffer was consumed by the error CQE.
                self.conn_resets += 1
                asm.reset()
                ud = None
                continue
            data = bytes(bring.buffers[cqe.buf_id][:cqe.res])
            bring.recycle(cqe.buf_id)
            self.chunks_in += 1
            for fr in asm.feed(data):
                self._handle(fr)
            if not (cqe.flags & CqeFlags.MORE):
                ud = None
        if ud is not None:
            yield StreamClose(ud)
        # wake the pipeline so it can drain and finish
        self.wal_gate.open()
        self.apply_gate.open()

    def _handle(self, fr) -> None:
        if fr.kind == FrameKind.HELLO:
            self.wal.adopt_header(fr.payload)
            self.tree.root = self.wal.header.root
            self.tree.next_pid = self.wal.header.next_pid
        elif fr.kind == FrameKind.WAL_SPAN:
            # overlap-tolerant: after a reconnect the primary resumes
            # from our last ACKED durable LSN, which may trail what we
            # already hold — slice the span to the suffix past our own
            # end.  A pure-overlap re-ship is dropped; a gap would mean
            # the stream lost bytes we never acked (impossible with
            # in-order delivery + whole-frame re-ship) and is an error.
            end = self.wal.end_lsn
            if fr.lsn_hi <= end:
                self.dup_spans += 1
            else:
                assert fr.lsn_lo <= end, \
                    f"ship stream gap: have {end}, got [{fr.lsn_lo}..)"
                if fr.lsn_lo < end:
                    self.overlap_spans += 1
                self.wal.append_raw(fr.payload[end - fr.lsn_lo:], end)
                self.spans_in += 1
                self.wal_gate.open()
        elif fr.kind == FrameKind.SHUTDOWN:
            self.shutdown = True
        else:
            raise AssertionError(f"unexpected frame on ship stream: "
                                 f"{FrameKind.name(fr.kind)}")

    def flusher(self):
        """Persist received spans via the standby WAL's normal flush
        path; ack the durable horizon after every flush."""
        w = self.wal
        while True:
            if w.end_lsn > w.durable_lsn:
                yield from w.flush_to(w.end_lsn)
                self.apply_gate.open()
                yield from self._send_ack()
            elif self.shutdown:
                break
            else:
                yield self.wal_gate
        self.flush_done = True
        self.apply_gate.open()

    def applier(self):
        """Redo durable records into the warm page image; ack the
        applied horizon (sync mode gates client commits on this)."""
        while True:
            target = self.wal.durable_lsn
            if self.applied_lsn < target:
                yield from self._apply_upto(target)
                self._sample_lag()
                yield from self._send_ack()
            elif self.shutdown and self.flush_done:
                yield from self._send_ack(fin=True)
                return
            else:
                yield self.apply_gate

    # --------------------------------------------------------- internals

    def _send_ack(self, fin: bool = False):
        """Ack the (durable, applied) horizons, retrying across link
        flaps.  Acks are cumulative and idempotent (absolute horizons,
        receiver takes the max), so a retry can only over-cover — but a
        DROPPED ack is not always harmless: when it is the last of a
        burst the primary has nothing left to ship, no bigger ack ever
        follows, and semisync/sync commits would park forever.  The
        frame is re-encoded each attempt so the eventual send carries
        the freshest horizons."""
        while True:
            frame = encode_frame(FrameKind.ACK, self.wal.durable_lsn,
                                 self.applied_lsn,
                                 b"\x01" if fin else b"")

            def prep(sqe, ud):
                prep_send(sqe, self.ack_fd, len(frame),
                          buf=memoryview(frame))
            cqe = yield IoRequest(prep)
            if cqe.res >= 0:
                self.acks_sent += 1
                return
            self.ack_send_errors += 1

            def prep_t(sqe, ud):
                prep_timeout(sqe, 200e-6)      # sleep out the flap
            yield IoRequest(prep_t)

    def _sample_lag(self) -> None:
        p = self.primary.wal
        self.lag_samples.append((self.tl.now,
                                 p.durable_lsn - self.wal.durable_lsn,
                                 p.durable_lsn - self.applied_lsn))

    def _prefetch(self, pids: List[int]):
        """Read-ahead fiber: fault one stripe of upcoming APPLY pages
        into the pool so the (serial) applier mostly hits.  Overlapping
        the 70 µs page reads across the SSD array is exactly the
        batched-submission win the paper's Fig. 5 ladder earns — a
        standby that faults one page at a time replays at single-I/O
        latency."""
        for pid in pids:
            if pid in self.pool.table or pid in self.pool.loading_pids:
                continue
            idx = yield from self.pool.fix(pid)
            self.pool.unfix(idx)

    def _spawn_prefetchers(self, target: int) -> None:
        """Pre-scan [scan_off, target) and stripe the missing APPLY
        pids over a few read-ahead fibers."""
        buf = self.wal.buf
        off = self._scan_off
        pids: Dict[int, None] = {}
        while off + _REC_HDR.size <= target:
            _, size, rtype, _ = _REC_HDR.unpack_from(buf, off)
            if size < _REC_HDR.size or off + size > target:
                break
            if rtype == RecordType.APPLY:
                _, _, entries = decode_apply(bytes(buf[off + 17:off + size]))
                for _, pid, _ in entries:
                    pids[pid] = None
            off += size
        missing = [p for p in pids if p not in self.pool.table]
        if len(missing) <= 2:
            return
        n = min(8, len(missing))
        for i in range(n):
            self.sched.spawn(self._prefetch(missing[i::n]),
                             core=self.core_idx, ring=self.ring_idx)

    def _apply_upto(self, target: int):
        """Incremental redo of [applied_lsn, target): the same
        physiological page redo as recovery pass 2, plus commit-order
        last-writer tracking from the intent/COMMIT records."""
        self._spawn_prefetchers(target)
        buf = self.wal.buf
        off = self._scan_off
        pool, tree = self.pool, self.tree
        while off + _REC_HDR.size <= target:
            crc, size, rtype, txn = _REC_HDR.unpack_from(buf, off)
            if size < _REC_HDR.size or off + size > target:
                break                     # flush targets are record-
            payload = bytes(buf[off + 17:off + size])   # aligned: guard
            self.core.charge(self.tl.now, APPLY_CPU_S)
            if rtype in (RecordType.UPDATE, RecordType.INSERT):
                key, _ = decode_kv(payload)
                self._intents.setdefault(txn, []).append(key)
            elif rtype == RecordType.COMMIT:
                self.commits.append(txn)
                for key in self._intents.pop(txn, []):
                    self.last_writer[key] = txn
            elif rtype == RecordType.ABORT:
                self._intents.pop(txn, None)
            elif rtype == RecordType.APPLY_END:
                self.applied_txns.add(txn)
            elif rtype == RecordType.CHECKPOINT:
                root, next_pid, _, _ = decode_checkpoint(payload)
                tree.root, tree.next_pid = root, next_pid
            elif rtype == RecordType.APPLY:
                root, next_pid, entries = decode_apply(payload)
                for kind, pid, data in entries:
                    idx = yield from pool.fix(pid)
                    if pool.page_lsn(idx) >= off and pool.page_lsn(idx) > 0:
                        self.pages_skipped += 1
                        pool.unfix(idx)
                        continue
                    page = pool.page(idx)
                    if kind == APPLY_IMG:
                        page[:] = data    # image embeds its page LSN
                    else:
                        key, value = decode_kv(data)
                        _redo_upsert(page, self.cfg.page_size,
                                     self.cfg.value_size, key, value)
                    pool.stamp_lsn(idx, off)
                    self.pages_redone += 1
                    pool.unfix(idx, dirty=True)
                tree.root, tree.next_pid = root, next_pid
            self.records_applied += 1
            off += size
            self._scan_off = off
            self.applied_lsn = off

    # ------------------------------------------------- failover / restore

    def log_image(self, durable_only: bool = False) -> bytes:
        """The standby's log as a recoverable image: the durable device
        image (cluster-wide power loss), or the in-memory log (the
        standby survived and can flush before promoting)."""
        if durable_only:
            return bytes(self.log_disk.image)
        img = bytes(self.wal.buf)
        return img if len(img) >= BLOCK else img + bytes(BLOCK - len(img))

    def crash_images(self):
        """Power loss on the standby too: both device images as-is."""
        return bytes(self.disk.image), bytes(self.log_disk.image)

    def promote(self, *, durable_only: bool = False,
                pool_frames: int = 4096):
        """Failover: rebuild a queryable engine from the standby's OWN
        state via the real recovery machinery.  ``full_redo`` because
        the shipped checkpoints' redo bounds describe the primary's
        disk, not ours; the page-LSN guard keeps the replay idempotent
        over whatever our own eviction schedule already persisted.
        Returns ``(RecoveredEngine, RecoveryReport)``."""
        return recover(bytes(self.disk.image),
                       self.log_image(durable_only),
                       pool_frames=pool_frames, full_redo=True)

    def point_in_time(self, target_lsn: int, *, pool_frames: int = 4096):
        """Restore base backup + shipped log up to ``target_lsn`` —
        exactly the archived-log PITR path.  Replays over the PRISTINE
        base image (the live one may already contain effects beyond the
        target)."""
        img = self.log_image()[:max(BLOCK, target_lsn)]
        return recover(self.base_image, img,
                       pool_frames=pool_frames, full_redo=True)
