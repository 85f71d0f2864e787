"""Buffer-managed storage engine core (paper §3.1).

Clock-sweep replacement, fix/unfix pin semantics, and the paper's
step-wise design ladder as configuration:

  PoolConfig(batch_evict=False, ...)    Posix/naive-io_uring baseline
  +batch_evict      batched eviction writes, one submission   (§3.3.1)
  (+fibers: run fix() inside a FiberScheduler with >1 fiber)  (§3.3.2)
  +fixed_bufs       registered buffers (zero pin/copy)        (§3.4.1)
  +passthrough      NVMe passthrough URING_CMD                (§3.4.1)
  (+IOPoll/+SQPoll: ring setup flags)                         (§3.4.1)

``fix``/``unfix`` are generators — they run inside fibers and yield
IoRequests; with a single fiber and EagerSubmit the behaviour degenerates
to the synchronous baseline exactly as in the paper.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field, replace
from typing import Dict, Generator, List, Optional

from repro_torch.core import IoRequest
from repro_torch.core.ring import (prep_read, prep_read_fixed, prep_write,
                                   prep_write_fixed)
from repro_torch.core.sqe import ENOTSUP, ETIME

PAGE = 4096

#: byte offset of the u64 page LSN inside every page's header — shared
#: with the B-tree node layout (repro.storage.btree imports this) and
#: the WAL's redo pass.
PAGE_LSN_OFF = 4


@dataclass
class PoolConfig:
    n_frames: int = 1024
    page_size: int = PAGE
    batch_evict: bool = True
    evict_batch: int = 16
    fixed_bufs: bool = True          # registered buffers
    passthrough: bool = False        # NVMe passthrough (no filesystem)
    fd: int = 3
    buf_base: int = 0                # registered-buffer slot of frame 0
                                     # (partitions of a sharded pool all
                                     # index one shared buffer table)


@dataclass
class Frame:
    pid: int = -1
    dirty: bool = False
    ref: bool = False
    pins: int = 0
    loading: bool = False
    rec_lsn: int = 0      # WAL LSN that first dirtied this frame since
                          # it was last clean (ARIES dirty-page table)


class BufferPool:
    def __init__(self, ring, cfg: PoolConfig):
        self.ring = ring
        self.cfg = cfg
        ps = cfg.page_size
        self.frames: List[bytearray] = [bytearray(ps)
                                        for _ in range(cfg.n_frames)]
        if cfg.fixed_bufs and ring is not None:
            # a partition of a sharded pool passes ring=None: the engine
            # registers the concatenated frame table on every ring
            ring.register_buffers(self.frames)
        self.meta = [Frame() for _ in range(cfg.n_frames)]
        self.table: Dict[int, int] = {}
        self.loading_pids: set = set()   # fault in progress (no frame yet)
        self.evicting_pids: set = set()  # dirty writeback in flight: a
                                         # re-fault would read STALE disk
        self.hand = 0
        self._clean_hand = 0       # clean_some's rotating scan cursor
        self.free: List[int] = list(range(cfg.n_frames))
        # WAL-before-data hook: when the engine attaches a WAL, dirty
        # pages cannot be written back until the log is durable up to
        # their page LSN (set by stamp_lsn).
        self.wal = None
        # multi-tier hook: ``placement(pid) -> (fd, offset, passthru)``
        # routes a page to its backing device.  None = the classic
        # single-file layout (cfg.fd, pid*page_size, cfg.passthrough).
        # The KV pager uses this to split pids between a host-DRAM
        # spill store and an NVMe cold tier.
        self.placement = None
        # stats
        self.hits = 0
        self.faults = 0
        self.evictions = 0
        self.writebacks = 0
        self.wal_waits = 0               # evictions that had to flush WAL
        # error-recovery surfaces (fault plane): reads re-issued after
        # an error/short CQE; writebacks whose frame was kept dirty
        # after a failed write (eviction must not lose data); passthru
        # reads degraded to the regular read path (ENOTSUP/timeout)
        self.read_retries = 0
        self.write_retries = 0
        self.passthru_fallbacks = 0
        # CQE -> frame mapping for batched I/O under faults: prep
        # closures record their ud here; never cleared wholesale
        # (concurrent fibers' evictions interleave), entries are popped
        # as their CQEs come back
        self._req_frame: Dict[int, tuple] = {}

    # ------------------------------------------------------------------

    def fix(self, pid: int) -> Generator:
        """Fiber-style: ``frame_idx = yield from pool.fix(pid)``.

        Single-load invariant: a faulting pid is registered in
        ``loading_pids`` BEFORE the (yielding) frame allocation, so a
        concurrent fix() of the same page waits instead of double-loading
        it into a second frame (whose eviction would then orphan the
        live table entry)."""
        while True:
            idx = self.table.get(pid)
            if idx is not None:
                m = self.meta[idx]
                # another fiber is loading this page: wait cooperatively
                while m.loading and self.table.get(pid) == idx:
                    yield None
                if self.table.get(pid) == idx and m.pid == pid:
                    m.ref = True
                    m.pins += 1
                    self.hits += 1
                    return idx
                continue                 # evicted while waiting: re-check
            if pid in self.loading_pids:
                yield None               # another fiber owns this fault
                continue
            if pid in self.evicting_pids:
                yield None               # writeback in flight: reading
                continue                 # disk now would lose the update
            break
        self.faults += 1
        self.loading_pids.add(pid)
        try:
            idx = yield from self._allocate()
        except BaseException:
            self.loading_pids.discard(pid)
            raise
        m = self.meta[idx]
        m.pid = pid
        m.dirty = False
        m.ref = True
        m.pins = 1
        m.loading = True
        self.table[pid] = idx
        self.loading_pids.discard(pid)
        yield from self._read_page(idx, pid)
        m.loading = False
        return idx

    def fix_new(self, pid: int) -> Generator:
        """Fiber-style ``adopt_new_page``: allocate a frame for a
        brand-new page, *yielding* through eviction when the pool is
        full (unlike ``adopt_new_page``, which can only steal a clean
        victim).  The page is born dirty and pinned; nothing is read
        from disk.  Used by the KV pager when a decode step appends a
        fresh KV block."""
        assert pid not in self.table and pid not in self.loading_pids \
            and pid not in self.evicting_pids, f"pid {pid} already live"
        self.loading_pids.add(pid)       # reserve against concurrent fix
        try:
            idx = yield from self._allocate()
        finally:
            self.loading_pids.discard(pid)
        m = self.meta[idx]
        m.pid = pid
        m.dirty = True
        m.ref = True
        m.pins = 1
        m.loading = False
        self.table[pid] = idx
        self.frames[idx][:] = bytes(self.cfg.page_size)
        return idx

    def prefetch_many(self, pids) -> Generator:
        """Read-ahead: fault every absent page of ``pids`` into the pool
        with ONE batched submission, leaving the frames unpinned
        (ref=True so the clock sweep gives them a full revolution).
        Pages already resident, loading, or mid-writeback are skipped —
        a prefetch must never double-load or read stale disk.  Returns
        the number of pages actually faulted."""
        grabbed: List[tuple] = []        # (idx, pid)
        for pid in pids:
            if (pid in self.table or pid in self.loading_pids
                    or pid in self.evicting_pids):
                continue
            self.loading_pids.add(pid)
            try:
                idx = yield from self._allocate()
            except BaseException:
                self.loading_pids.discard(pid)
                raise
            m = self.meta[idx]
            m.pid = pid
            m.dirty = False
            m.ref = True
            m.pins = 0                   # prefetched, not pinned
            m.loading = True
            self.table[pid] = idx
            self.loading_pids.discard(pid)
            grabbed.append((idx, pid))
        if not grabbed:
            return 0
        self.faults += len(grabbed)
        cqes = yield [self._read_req(i, p) for i, p in grabbed]
        for cqe in cqes:               # CQEs arrive in completion order:
            i, p = self._req_frame.pop(cqe.user_data)   # map via ud
            if cqe.res != self.cfg.page_size:
                yield from self._read_page(i, p, res0=cqe.res)
            self.meta[i].loading = False
        return len(grabbed)

    def _backing(self, pid: int):
        """(fd, byte offset, passthru?) of a page's backing store."""
        if self.placement is not None:
            return self.placement(pid)
        cfg = self.cfg
        return cfg.fd, pid * cfg.page_size, cfg.passthrough

    #: read-repair budget: errored/short page reads are re-issued up to
    #: this many times before the pool gives up (reads are idempotent,
    #: so the only cost of a retry is latency)
    MAX_READ_RETRIES = 8

    def _read_req(self, idx: int, pid: int,
                  pthru_override: Optional[bool] = None) -> IoRequest:
        cfg = self.cfg
        fd, off, pthru = self._backing(pid)
        if pthru_override is not None:
            pthru = pthru_override

        def prep(sqe, ud, idx=idx, pid=pid, fd=fd, off=off, pthru=pthru):
            if cfg.fixed_bufs:
                prep_read_fixed(sqe, fd, cfg.buf_base + idx, off,
                                cfg.page_size)
            else:
                prep_read(sqe, fd, memoryview(self.frames[idx]), off,
                          cfg.page_size)
            if pthru:             # URING_CMD: bypass the storage stack
                sqe.cmd = "passthru"
            self._req_frame[ud] = (idx, pid)
        return IoRequest(prep)

    def _read_page(self, idx: int, pid: int,
                   res0: Optional[int] = None) -> Generator:
        """Read page ``pid`` into frame ``idx``, retrying errored or
        short completions (recovery policy: reads are idempotent, so
        re-issue the whole page up to ``MAX_READ_RETRIES`` times).  A
        passthrough read that fails with ENOTSUP or a device timeout is
        degraded to the regular read path — counted once per page in
        ``passthru_fallbacks`` — mirroring a real engine falling back
        from io_uring-cmd to plain reads on kernels/devices without
        passthrough support.  ``res0`` carries the result of an
        already-completed first attempt (batched prefetch)."""
        pthru_override: Optional[bool] = None
        attempt = 0
        res = res0
        while True:
            if res is None:
                cqe = yield self._read_req(idx, pid, pthru_override)
                self._req_frame.pop(cqe.user_data, None)
                res = cqe.res
            if res == self.cfg.page_size:
                return
            if res in (ENOTSUP, ETIME) and pthru_override is None \
                    and self._backing(pid)[2]:
                # degrade this page's read to the non-passthru path
                pthru_override = False
                self.passthru_fallbacks += 1
                if self.ring is not None:
                    self.ring.stats.passthru_fallbacks += 1
            attempt += 1
            if attempt > self.MAX_READ_RETRIES:
                raise RuntimeError(
                    f"page {pid} read failed after "
                    f"{self.MAX_READ_RETRIES} retries (res={res})")
            self.read_retries += 1
            res = None

    def unfix(self, idx: int, dirty: bool = False) -> None:
        m = self.meta[idx]
        m.pins -= 1
        assert m.pins >= 0
        if dirty:
            m.dirty = True

    def page(self, idx: int) -> bytearray:
        return self.frames[idx]

    # ------------------------------------------------- WAL integration

    def stamp_lsn(self, idx: int, lsn: int) -> None:
        """Record that APPLY record ``lsn`` modified this frame: write
        the page LSN into the page header and track the frame's recLSN
        for the dirty-page table."""
        struct.pack_into("<Q", self.frames[idx], PAGE_LSN_OFF, lsn)
        m = self.meta[idx]
        if m.rec_lsn == 0:
            m.rec_lsn = lsn

    def page_lsn(self, idx: int) -> int:
        return struct.unpack_from("<Q", self.frames[idx], PAGE_LSN_OFF)[0]

    def dirty_page_table(self) -> Dict[int, int]:
        """{pid: recLSN} of every dirty resident page (fuzzy-checkpoint
        payload)."""
        return {m.pid: m.rec_lsn for m in self.meta
                if m.pid >= 0 and m.dirty and m.rec_lsn > 0}

    def adopt_new_page(self, pid: int) -> int:
        """Allocate a frame for a brand-new page (B-tree split) WITHOUT
        yielding: uses a free frame or steals a clean unpinned victim.
        New pages reach disk through normal dirty eviction."""
        idx = self.free.pop() if self.free else self._steal_clean()
        m = self.meta[idx]
        m.pid = pid
        m.dirty = True
        m.ref = True
        m.pins = 1
        m.loading = False
        self.table[pid] = idx
        self.frames[idx][:] = bytes(self.cfg.page_size)
        return idx

    def unfix_new(self, idx: int) -> None:
        self.unfix(idx, dirty=True)

    def _steal_clean(self) -> int:
        n = self.cfg.n_frames
        for _ in range(2 * n):
            i = self.hand
            m = self.meta[i]
            self.hand = (self.hand + 1) % n
            if m.pins == 0 and not m.dirty and not m.loading and m.pid >= 0:
                self.table.pop(m.pid, None)
                self.evictions += 1
                return i
        raise RuntimeError("no clean frame available for a new page")

    # ------------------------------------------------------------------

    def _allocate(self) -> Generator:
        if self.free:
            return self.free.pop()
        while True:
            n = yield from self.evict_some()
            if self.free:
                return self.free.pop()
            if n == 0:              # everything pinned/loading: wait
                yield None

    def clean_some(self) -> Generator:
        """Write back one batch of dirty unpinned frames but KEEP them
        resident (checkpoint flushing).  The frames are marked
        ``loading`` for the write's flight so no fiber can modify the
        page between the WAL flush and the data write — the same
        invariant eviction relies on.  Returns the number cleaned."""
        n = self.cfg.n_frames
        victims = []
        for k in range(n):                    # rotating cursor: a fixed
            i = (self._clean_hand + k) % n    # start index would starve
            m = self.meta[i]                  # high frames forever
            if m.dirty and m.pins == 0 and not m.loading:
                victims.append(i)
                if len(victims) >= self.cfg.evict_batch:
                    break
        self._clean_hand = (victims[-1] + 1) % n if victims else 0
        if not victims:
            return 0
        for i in victims:
            self.meta[i].loading = True
        if self.wal is not None:
            need = max(self.page_lsn(i) for i in victims)
            if need > self.wal.durable_lsn:
                self.wal_waits += 1
                yield from self.wal.flush_to(need)
        self.writebacks += len(victims)
        reqs = [self._write_req(i) for i in victims]
        if self.cfg.batch_evict:
            cqes = yield reqs
        else:
            cqes = []
            for r in reqs:
                cqes.append((yield r))
        cleaned = 0
        for cqe in cqes:
            i, _ = self._req_frame.pop(cqe.user_data)
            m = self.meta[i]
            if cqe.res != self.cfg.page_size:
                # failed/short writeback: the frame STAYS dirty (and
                # keeps its recLSN) so a later pass retries — a
                # checkpoint must never mark a page clean off a failed
                # write
                self.write_retries += 1
                m.loading = False
                continue
            m.dirty = False
            m.rec_lsn = 0
            m.loading = False
            cleaned += 1
        return cleaned

    def evict_some(self) -> Generator:
        """Evict up to one clock-sweep batch of victims (writing dirty
        ones back under the WAL-before-data rule) and put the frames on
        the free list.  Returns the number of frames freed.  Also used
        by the engine's background page cleaner so that write-heavy
        in-memory workloads keep clean frames available for B-tree
        splits (``adopt_new_page`` cannot suspend)."""
        victims = self._clock_sweep()
        if not victims:
            return 0
        # reserve immediately: drop from the table and mark loading so no
        # concurrent fiber can pin (or steal) a frame whose writeback is
        # still in flight
        for i in victims:
            self.table.pop(self.meta[i].pid, None)
            self.meta[i].loading = True
        dirty = [i for i in victims if self.meta[i].dirty]
        failed: set = set()
        if dirty:
            for i in dirty:          # block re-faults until disk is current
                self.evicting_pids.add(self.meta[i].pid)
            # WAL-before-data: the log must be durable up to the newest
            # APPLY LSN of any victim before its bytes may hit the data
            # disk (otherwise a crash could expose unlogged changes)
            if self.wal is not None:
                need = max(self.page_lsn(i) for i in dirty)
                if need > self.wal.durable_lsn:
                    self.wal_waits += 1
                    yield from self.wal.flush_to(need)
            self.writebacks += len(dirty)
            reqs = [self._write_req(i) for i in dirty]
            if self.cfg.batch_evict:
                cqes = yield reqs                # ONE submission, N writes
            else:
                cqes = []
                for r in reqs:                   # naive: one at a time
                    cqes.append((yield r))
            for cqe in cqes:
                i, pid = self._req_frame.pop(cqe.user_data)
                m = self.meta[i]
                if cqe.res != self.cfg.page_size:
                    # failed/short writeback: eviction must NOT lose
                    # data — the frame stays DIRTY and RESIDENT (it is
                    # re-inserted into the table; evicting_pids held it
                    # against re-faults, so the slot is free) and will
                    # be picked again by a later sweep, which retries
                    # the write
                    self.write_retries += 1
                    failed.add(i)
                    self.table[pid] = i
                    self.evicting_pids.discard(pid)
                    m.loading = False
                    m.ref = True     # full clock revolution before retry
                    continue
                m.dirty = False
                m.rec_lsn = 0
                self.evicting_pids.discard(pid)
        freed = 0
        for i in victims:
            if i in failed:
                continue
            self.evictions += 1
            self.meta[i].pid = -1
            self.meta[i].loading = False
            self.free.append(i)
            freed += 1
        return freed

    def _clock_sweep(self) -> List[int]:
        """Second-chance sweep collecting up to evict_batch victims (one
        when batch_evict is off)."""
        want = self.cfg.evict_batch if self.cfg.batch_evict else 1
        out: List[int] = []
        spins = 0
        n = self.cfg.n_frames
        while len(out) < want and spins < 4 * n:
            m = self.meta[self.hand]
            i = self.hand
            self.hand = (self.hand + 1) % n
            spins += 1
            if m.pins > 0 or m.pid < 0 or m.loading:
                continue
            if m.ref:
                m.ref = False                   # first pass: unmark
                continue
            if i in out:                        # hand wrapped: no dups
                continue
            out.append(i)
        return out

    def _write_req(self, idx: int) -> IoRequest:
        cfg = self.cfg
        fd, off, pthru = self._backing(self.meta[idx].pid)

        def prep(sqe, ud, idx=idx, fd=fd, off=off, pthru=pthru):
            if cfg.fixed_bufs:
                prep_write_fixed(sqe, fd, cfg.buf_base + idx, off,
                                 cfg.page_size)
            else:
                prep_write(sqe, fd, memoryview(self.frames[idx]), off,
                           cfg.page_size)
            if pthru:
                sqe.cmd = "passthru"
            self._req_frame[ud] = (idx, self.meta[idx].pid)
        return IoRequest(prep)

    def register_metrics(self, reg, prefix: str) -> None:
        """Pool stat surface for the telemetry sampler: windowed hit
        rate (Δhits / Δaccesses per interval), cumulative fault/
        writeback counters, and the free-list depth gauge.  Pure
        reads."""
        reg.wrate(f"{prefix}/hit_rate", lambda: self.hits,
                  lambda: self.hits + self.faults, unit="frac")
        reg.counter(f"{prefix}/faults", lambda: self.faults)
        reg.counter(f"{prefix}/writebacks", lambda: self.writebacks)
        reg.counter(f"{prefix}/wal_waits", lambda: self.wal_waits)
        reg.gauge(f"{prefix}/free_frames", lambda: len(self.free))
        reg.counter(f"{prefix}/read_retries", lambda: self.read_retries)
        reg.counter(f"{prefix}/write_retries", lambda: self.write_retries)
        reg.counter(f"{prefix}/passthru_fallbacks",
                    lambda: self.passthru_fallbacks)


# ---------------------------------------------------------------------------
# partitioned pool (multi-core scale-up)
# ---------------------------------------------------------------------------

class _PartitionTable:
    """Read-only {pid -> global frame idx} view over all partitions."""

    __slots__ = ("pp",)

    def __init__(self, pp: "PartitionedBufferPool"):
        self.pp = pp

    def __getitem__(self, pid: int) -> int:
        pp = self.pp
        p = pid % pp.n_parts
        return p * pp.frames_per_part + pp.parts[p].table[pid]

    def get(self, pid: int, default=None):
        try:
            return self[pid]
        except KeyError:
            return default

    def __contains__(self, pid: int) -> bool:
        return pid in self.pp.parts[pid % self.pp.n_parts].table

    def __len__(self) -> int:
        return sum(len(p.table) for p in self.pp.parts)


class PartitionedBufferPool:
    """Hash-partitioned buffer pool for the multi-core storage engine.

    Frames are sharded into ``n_parts`` independent ``BufferPool``
    partitions (``pid % n_parts``), each with its own hash table, free
    list and clock hand — the classic scale-up recipe: cores mostly
    touch their own partition's metadata and never contend on a global
    latch.  Partition p is *owned* by core p; an access from any other
    core charges a modeled partition-latch handoff (cache-line transfer
    + atomic) to the accessing core, so cross-partition traffic shows
    up in the throughput curve instead of being free.

    The accessing core is tracked via ``cur_core``, set by the
    scheduler's ``on_resume`` hook — correct because everything between
    two fiber suspension points executes synchronously.

    Frame indices returned by ``fix`` are *global*
    (``part * frames_per_part + local``), so callers (B-tree, WAL
    APPLY framing, page-LSN stamping) are oblivious to the sharding.
    Partitions are built with ``ring=None``: with registered buffers
    the engine registers the concatenated frame table on every core's
    ring, and each partition addresses it through ``PoolConfig.buf_base``.
    """

    def __init__(self, cfg: PoolConfig, *, n_parts: int, tl, cores,
                 latch_cycles: float = 300.0, clock_hz: float = 3.7e9):
        assert n_parts >= 1
        per = cfg.n_frames // n_parts
        assert per >= 2 * cfg.evict_batch, \
            "pool too small for the partition count"
        self.cfg = replace(cfg, n_frames=per * n_parts)
        self.n_parts = n_parts
        self.frames_per_part = per
        self.parts: List[BufferPool] = [
            BufferPool(None, replace(cfg, n_frames=per,
                                     buf_base=cfg.buf_base + p * per))
            for p in range(n_parts)]
        self.tl = tl
        self.cores = cores
        self.latch_s = latch_cycles / clock_hz
        self.cur_core = 0
        self.table = _PartitionTable(self)
        self.latch_cross = 0             # cross-partition fixes (paid)
        self.latch_local = 0             # own-partition fixes (free)

    # ------------------------------------------------------- delegation

    def _latch(self, part: int) -> None:
        if part == self.cur_core % self.n_parts:
            self.latch_local += 1
            return
        self.latch_cross += 1
        self.cores[self.cur_core].charge(self.tl.now, self.latch_s)

    def fix(self, pid: int) -> Generator:
        p = pid % self.n_parts
        self._latch(p)
        idx = yield from self.parts[p].fix(pid)
        return p * self.frames_per_part + idx

    def unfix(self, idx: int, dirty: bool = False) -> None:
        self.parts[idx // self.frames_per_part].unfix(
            idx % self.frames_per_part, dirty)

    def page(self, idx: int) -> bytearray:
        return self.parts[idx // self.frames_per_part].page(
            idx % self.frames_per_part)

    def stamp_lsn(self, idx: int, lsn: int) -> None:
        self.parts[idx // self.frames_per_part].stamp_lsn(
            idx % self.frames_per_part, lsn)

    def page_lsn(self, idx: int) -> int:
        return self.parts[idx // self.frames_per_part].page_lsn(
            idx % self.frames_per_part)

    def adopt_new_page(self, pid: int) -> int:
        p = pid % self.n_parts
        self._latch(p)
        return p * self.frames_per_part + self.parts[p].adopt_new_page(pid)

    def unfix_new(self, idx: int) -> None:
        self.unfix(idx, dirty=True)

    def dirty_page_table(self) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for p in self.parts:
            out.update(p.dirty_page_table())
        return out

    def clean_some(self) -> Generator:
        """One checkpoint-flush batch per partition; returns the total
        cleaned (0 only once every partition is clean)."""
        total = 0
        for p in self.parts:
            total += yield from p.clean_some()
        return total

    def evict_some(self) -> Generator:
        total = 0
        for p in self.parts:
            total += yield from p.evict_some()
        return total

    # ------------------------------------------------------- aggregates

    @property
    def frames(self) -> List[bytearray]:
        """Concatenated frame table in global-index order (registered-
        buffer slot i is frame i)."""
        return [f for p in self.parts for f in p.frames]

    @property
    def wal(self):
        return self.parts[0].wal

    @wal.setter
    def wal(self, w) -> None:
        for p in self.parts:
            p.wal = w

    @property
    def hits(self) -> int:
        return sum(p.hits for p in self.parts)

    @property
    def faults(self) -> int:
        return sum(p.faults for p in self.parts)

    @property
    def evictions(self) -> int:
        return sum(p.evictions for p in self.parts)

    @property
    def writebacks(self) -> int:
        return sum(p.writebacks for p in self.parts)

    @property
    def wal_waits(self) -> int:
        return sum(p.wal_waits for p in self.parts)

    @property
    def read_retries(self) -> int:
        return sum(p.read_retries for p in self.parts)

    @property
    def write_retries(self) -> int:
        return sum(p.write_retries for p in self.parts)

    @property
    def passthru_fallbacks(self) -> int:
        return sum(p.passthru_fallbacks for p in self.parts)

    def register_metrics(self, reg, prefix: str) -> None:
        """Partitioned-pool stat surface: the aggregate hit rate /
        counters of the single-core pool plus the latch split."""
        reg.wrate(f"{prefix}/hit_rate", lambda: self.hits,
                  lambda: self.hits + self.faults, unit="frac")
        reg.counter(f"{prefix}/faults", lambda: self.faults)
        reg.counter(f"{prefix}/writebacks", lambda: self.writebacks)
        reg.counter(f"{prefix}/wal_waits", lambda: self.wal_waits)
        reg.gauge(f"{prefix}/free_frames",
                  lambda: sum(len(p.free) for p in self.parts))
        reg.counter(f"{prefix}/latch_cross", lambda: self.latch_cross)
        reg.counter(f"{prefix}/read_retries", lambda: self.read_retries)
        reg.counter(f"{prefix}/write_retries", lambda: self.write_retries)
        reg.counter(f"{prefix}/passthru_fallbacks",
                    lambda: self.passthru_fallbacks)
