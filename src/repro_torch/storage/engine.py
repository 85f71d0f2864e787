"""Storage-engine assembly: the paper's Fig. 5 design ladder as a config.

Each ``EngineConfig`` names one rung:

    posix        synchronous, 1 outstanding I/O (pread/pwrite equivalent)
    io_uring     same, but through the ring (paper: "when it does not help")
    +BatchEvict  batched eviction writes
    +Fibers      asynchronous transaction execution (N fibers)
    +BatchSubmit adaptive batched read submission
    +RegBufs     registered buffers
    +Passthru    NVMe passthrough
    +IOPoll      completion polling
    +SQPoll      submission polling (dedicated core)

and, with the WAL subsystem (paper Fig. 9 / §3.4.2 — see ``repro.wal``),
the durability rungs:

    +WAL           write-ahead log, per-txn commit (write+fsync; the
                   fsync rides the io_worker fallback)
    +GroupCommit   group-commit coordinator, ONE linked write→fsync
                   chain per batch of committers
    +PassthruFlush group commit over a passthrough log device with an
                   NVMe flush command (enterprise/PLP: ~5 µs barrier)

and the multi-core scale-up rungs (paper §3.3 "one ring per thread" /
§2.2 SINGLE_ISSUER+DEFER_TASKRUN — this is where io_uring's gains
finally multiply instead of saturating):

    +MultiCore(N)  N cores, ring-per-core (SINGLE_ISSUER+DEFER_TASKRUN,
                   a private AdaptiveBatcher per ring), hash-partitioned
                   buffer pool (cross-partition access pays a modeled
                   latch handoff), 128 worker fibers per core
    +SharedRing(N) the ANTI-PATTERN baseline: the same N cores but ONE
                   ring — every get_sqe/submit serializes on a modeled
                   ring lock and completions IPI the submitting core
                   (no DEFER_TASKRUN), reproducing the kernel-side
                   contention that SteelDB blames for cloud-OLTP stalls

``EngineConfig.multicore(n)`` builds either rung for any core count;
the 1-core engine (``n_cores=1``) takes the exact single-core code path
of the earlier rungs, bit for bit.  Under a durable rung the multi-core
engine routes commits through cross-core commit queues into ONE leader
fiber (``repro.wal.group_commit.MultiCoreGroupCommit``), so fsync
submission stays single-issuer while commit points arrive from every
core.

Transactions under a durable rung are redo-only with deferred apply:
``Txn.update``/``insert`` stream intent records into the log and buffer
the write-set; ``StorageEngine.commit`` appends COMMIT, suspends the
fiber until its LSN is durable, then applies the write-set to the
B-tree, framing one APPLY record per tree op (page deltas/images) so
crash recovery can redo physiologically.  See ``repro.wal`` for the
full protocol and ``repro.wal.recovery`` for the other half.
"""

from __future__ import annotations

import itertools
import struct as _struct
from dataclasses import dataclass, field
from typing import Dict, Generator, List, Optional, Tuple

import numpy as np

from repro_torch.bufferpool import (BufferPool, PartitionedBufferPool,
                                    PoolConfig)
from repro_torch.core import (AdaptiveBatcher, AdaptiveFlush, CoreClock,
    EagerSubmit, FiberScheduler, IoUring, NVMeSpec, SetupFlags, Timeline)
from repro_torch.core.backends import DATA_FD, LOG_FD, SimDisk
from repro_torch.core.faults import FaultSpec, maybe_plane
from repro_torch.observe import metrics as _metrics
from repro_torch.storage.btree import BTree, bulk_load
from repro_torch.wal.group_commit import GroupCommit, MultiCoreGroupCommit
from repro_torch.wal.log import (APPLY_DELTA, APPLY_IMG, LogHeader, RecordType,
                                 WriteAheadLog, encode_apply,
                                 encode_checkpoint, encode_kv, encode_record)

# DATA_FD / LOG_FD re-exported from repro.core.backends — the named
# device-registration slots are shared with the serving tier (KV_HOST_FD,
# KV_NVME_FD) so no two subsystems collide on a magic fd.

#: durability config -> WAL flush path (paper Fig. 9)
_DURABILITY_MODES = {
    "none": None,
    "wal": "fsync",               # write, wait, fsync (worker fallback)
    "group": "linked",            # one linked write->fsync chain
    "passthru-flush": "passthru",  # passthrough write + NVMe flush (PLP)
}


@dataclass
class EngineConfig:
    name: str = "+BatchSubmit"
    n_fibers: int = 128
    batch_evict: bool = True
    adaptive_batch: bool = True
    fixed_bufs: bool = False
    passthrough: bool = False
    iopoll: bool = False
    sqpoll: bool = False
    pool_frames: int = 8192
    page_size: int = 4096
    value_size: int = 120
    evict_batch: int = 16
    # durability ladder (repro.wal): none | wal | group | passthru-flush
    durability: str = "none"
    log_capacity: int = 64 * 1024 * 1024
    ckpt_every: int = 0           # fuzzy checkpoint every N commits (0=off)
    truncate_wal: bool = True     # reclaim log below the checkpoint's
                                  # redo horizon (min recLSN / oldest txn);
                                  # the checkpoint's txn-table snapshot
                                  # keeps truncated COMMITs in recovery's
                                  # winner set, so this defaults on now
    # multi-core scale-up (the +MultiCore(N)/+SharedRing(N) rungs)
    n_cores: int = 1              # 1 = the exact single-core code path
    shared_ring: bool = False     # anti-pattern: one contended ring
    # group-commit leader defers flushes on the inflight-vs-queued
    # signal (AdaptiveFlush) instead of flushing eagerly
    adaptive_commit: bool = False
    # replication rung (repro.replication): off | async | semisync | sync.
    # The config alone changes NOTHING — a plain StorageEngine stays
    # bit-for-bit the single-node engine; ``ReplicatedCluster`` reads the
    # mode, builds the standby, and installs the commit-gating hook.
    repl: str = "off"
    # fault-injection plane (repro.core.faults): None or an all-zero
    # spec is STRUCTURALLY identical to no plane — the backends never
    # see it and consume no randomness, so every existing rung stays
    # bit-for-bit unchanged.  With nonzero rates, ONE shared plane (one
    # seeded RNG, consumed in sim event order) is attached to the data
    # and log devices (and, by ReplicatedCluster, to the link sockets).
    faults: Optional[FaultSpec] = None
    # storage-engine selector (repro.lsm): "btree" keeps every rung on
    # the exact code path above — none of the knobs below are read by
    # StorageEngine, so existing configs stay bit-for-bit unchanged.
    # "lsm" builds an LSMEngine via ``make_engine``
    engine: str = "btree"
    memtable_bytes: int = 64 * 1024      # rotation threshold
    sstable_bytes: int = 256 * 1024      # max data bytes per table
    l0_trigger: int = 4                  # L0 tables before compaction
    level_fanout: int = 4                # per-level capacity ratio
    bloom_bits_per_key: int = 10
    kernel_compaction: bool = False      # the +KernelCompaction rung

    @staticmethod
    def ladder():
        """The paper's incremental configurations (Fig. 5), in order,
        extended with the Fig. 9 durability rungs and the multi-core
        scale-up rungs (ring-per-core vs the shared-ring anti-pattern;
        see ``EngineConfig.multicore``)."""
        base = dict(pool_frames=8192)
        return [
            EngineConfig("posix", n_fibers=1, batch_evict=False,
                         adaptive_batch=False, **base),
            EngineConfig("io_uring", n_fibers=1, batch_evict=False,
                         adaptive_batch=False, **base),
            EngineConfig("+BatchEvict", n_fibers=1, batch_evict=True,
                         adaptive_batch=False, **base),
            EngineConfig("+Fibers", n_fibers=128, batch_evict=True,
                         adaptive_batch=False, **base),
            EngineConfig("+BatchSubmit", n_fibers=128, batch_evict=True,
                         adaptive_batch=True, **base),
            EngineConfig("+RegBufs", n_fibers=128, batch_evict=True,
                         adaptive_batch=True, fixed_bufs=True, **base),
            EngineConfig("+Passthru", n_fibers=128, batch_evict=True,
                         adaptive_batch=True, fixed_bufs=True,
                         passthrough=True, **base),
            EngineConfig("+IOPoll", n_fibers=128, batch_evict=True,
                         adaptive_batch=True, fixed_bufs=True,
                         passthrough=True, iopoll=True, **base),
            EngineConfig("+SQPoll", n_fibers=128, batch_evict=True,
                         adaptive_batch=True, fixed_bufs=True,
                         passthrough=True, iopoll=True, sqpoll=True,
                         **base),
            EngineConfig("+WAL", n_fibers=128, batch_evict=True,
                         adaptive_batch=True, durability="wal", **base),
            EngineConfig("+GroupCommit", n_fibers=128, batch_evict=True,
                         adaptive_batch=True, fixed_bufs=True,
                         durability="group", **base),
            EngineConfig("+PassthruFlush", n_fibers=128, batch_evict=True,
                         adaptive_batch=True, fixed_bufs=True,
                         passthrough=True, durability="passthru-flush",
                         **base),
            # replicated durability rungs (repro.replication): log
            # shipping over the ring on top of +GroupCommit.  async =
            # ship after local flush; semisync = commit acked once the
            # standby's WAL is durable; sync = once the standby APPLIED
            EngineConfig("+AsyncRepl", n_fibers=128, batch_evict=True,
                         adaptive_batch=True, fixed_bufs=True,
                         durability="group", repl="async", **base),
            EngineConfig("+SemiSync", n_fibers=128, batch_evict=True,
                         adaptive_batch=True, fixed_bufs=True,
                         durability="group", repl="semisync", **base),
            EngineConfig("+SyncRepl", n_fibers=128, batch_evict=True,
                         adaptive_batch=True, fixed_bufs=True,
                         durability="group", repl="sync", **base),
            EngineConfig.multicore(4, shared_ring=True),
            EngineConfig.multicore(4),
        ]

    @classmethod
    def lsm(cls, *, kernel_compaction: bool = False,
            **kw) -> "EngineConfig":
        """The LSM rungs (repro.lsm): ``lsm`` — ring-native LSM engine
        with host-side background compaction — and
        ``lsm+KernelCompaction``, the in-kernel (eBPF-style) offload
        rung where merge CPU leaves the foreground core.  Defaults to
        the passthrough flush path: SSTable barriers are ~5 µs NVMe
        flush commands instead of 1 ms worker-path fsyncs, which is
        what a log-structured engine on a PLP device would run."""
        name = "lsm+KernelCompaction" if kernel_compaction else "lsm"
        kw.setdefault("n_fibers", 128)
        kw.setdefault("adaptive_batch", True)
        kw.setdefault("fixed_bufs", True)
        kw.setdefault("passthrough", True)
        kw.setdefault("durability", "passthru-flush")
        return cls(name, engine="lsm",
                   kernel_compaction=kernel_compaction, **kw)

    @classmethod
    def multicore(cls, n_cores: int, *, shared_ring: bool = False,
                  **kw) -> "EngineConfig":
        """The scale-up rung for an arbitrary core count: +BatchSubmit
        semantics per core, 128 worker fibers per core (capped so the
        aggregate stays under the device's nr_requests cliff), either
        ring-per-core (the paper's recommendation) or the one-shared-
        ring anti-pattern."""
        name = (f"+SharedRing({n_cores})" if shared_ring
                else f"+MultiCore({n_cores})")
        kw.setdefault("pool_frames", 8192)
        kw.setdefault("n_fibers", min(128 * n_cores, 768))
        return cls(name, batch_evict=True, adaptive_batch=True,
                   n_cores=n_cores, shared_ring=shared_ring, **kw)


class Txn:
    """One transaction's handle.  Under a durable rung, writes are
    buffered (deferred apply) and logged as intents; without a WAL the
    calls pass straight through to the tree, so the original ladder
    rungs behave exactly as before."""

    __slots__ = ("engine", "id", "writes", "_began", "done")

    def __init__(self, engine: "StorageEngine", txn_id: int):
        self.engine = engine
        self.id = txn_id
        self.writes: List[Tuple[int, bytes, int]] = []   # key, val, rtype
        self._began = False
        self.done = False

    def lookup(self, key: int) -> Generator:
        for k, v, _ in reversed(self.writes):     # read-your-writes
            if k == key:
                return v
        out = yield from self.engine.tree.lookup(key)
        return out

    def update(self, key: int, value: bytes) -> Generator:
        e = self.engine
        if e.wal is None:
            ok = yield from e.tree.update(key, value)
            return ok
        self._intent(RecordType.UPDATE, key, value)
        return True

    def insert(self, key: int, value: bytes) -> Generator:
        e = self.engine
        if e.wal is None:
            ok = yield from e.tree.insert(key, value)
            return ok
        self._intent(RecordType.INSERT, key, value)
        return True

    def _intent(self, rtype: int, key: int, value: bytes) -> None:
        wal = self.engine.wal
        if not self._began:
            lsn = wal.append(encode_record(RecordType.BEGIN, self.id))
            # truncation bound: this txn's records (intents through
            # APPLY_END) must survive until it is fully applied
            self.engine._active_begin[self.id] = lsn
            self._began = True
        wal.append(encode_kv(rtype, self.id, key, value))
        self.writes.append((key, value, rtype))


class StorageEngine:
    """Timeline + ring + pool + B-tree (+ WAL), wired per EngineConfig."""

    def __init__(self, cfg: EngineConfig, *, n_tuples: int = 200_000,
                 spec: Optional[NVMeSpec] = None, seed: int = 0):
        self.cfg = cfg
        self.tl = Timeline()
        self.n_cores = max(1, int(cfg.n_cores))
        self.mc = self.n_cores > 1
        setup = SetupFlags.SINGLE_ISSUER | SetupFlags.DEFER_TASKRUN
        if cfg.iopoll:
            setup |= SetupFlags.IOPOLL
        if cfg.sqpoll:
            setup |= SetupFlags.SQPOLL
        self._cur_core = 0
        if not self.mc:
            self.cores: Optional[List[CoreClock]] = None
            self.ring = IoUring(self.tl, sq_depth=512, setup=setup)
            self.rings = [self.ring]
        else:
            self.cores = [CoreClock() for _ in range(self.n_cores)]
            if cfg.shared_ring:
                # the anti-pattern: ONE ring for all cores — default
                # task-work mode (completions IPI the submitter, no
                # DEFER_TASKRUN) and a contended SQ lock; the scheduler
                # re-points ring.core at each resumed fiber's core
                self.rings = [IoUring(self.tl, sq_depth=512,
                                      setup=SetupFlags.NONE,
                                      core=self.cores[0], contended=True)]
            else:
                # the paper's recommendation: ring-per-core, each
                # SINGLE_ISSUER + DEFER_TASKRUN on its own CoreClock
                self.rings = [IoUring(self.tl, sq_depth=512, setup=setup,
                                      core=c) for c in self.cores]
            self.ring = self.rings[0]

        # data: n_tuples of (int64 key, value_size bytes)
        keys = np.arange(n_tuples, dtype=np.int64)
        rng = np.random.default_rng(seed)
        vals = rng.integers(0, 256, (n_tuples, cfg.value_size),
                            dtype=np.uint8)
        from repro_torch.storage.btree import leaf_fanout
        est_pages = int(n_tuples / max(1, int(
            leaf_fanout(cfg.page_size, cfg.value_size) * 0.8)) * 1.3) + 64
        spec = spec or NVMeSpec()
        disk = SimDisk(self.tl, est_pages * cfg.page_size * 2,
                       spec=spec,
                       filesystem=not cfg.passthrough)
        self.disk = disk
        # fault plane: one plane, one RNG, every backend (see
        # EngineConfig.faults) — None when the spec is absent/all-zero
        self.faults = maybe_plane(cfg.faults)
        if self.faults is not None:
            disk.faults = self.faults
        for r in self.rings:
            r.register_device(DATA_FD, disk)
        root, next_pid = bulk_load(disk.image, keys, vals,
                                   page_size=cfg.page_size,
                                   value_size=cfg.value_size)
        self.n_pages = next_pid
        pcfg = PoolConfig(
            n_frames=cfg.pool_frames, page_size=cfg.page_size,
            batch_evict=cfg.batch_evict, evict_batch=cfg.evict_batch,
            fixed_bufs=cfg.fixed_bufs, passthrough=cfg.passthrough,
            fd=DATA_FD)
        if not self.mc:
            self.pool = BufferPool(self.ring, pcfg)
        else:
            self.pool = PartitionedBufferPool(
                pcfg, n_parts=self.n_cores, tl=self.tl, cores=self.cores)
        self.tree = BTree(self.pool, root, next_pid,
                          value_size=cfg.value_size)
        def _policy():
            return AdaptiveBatcher() if cfg.adaptive_batch \
                else EagerSubmit()
        if not self.mc:
            self.sched = FiberScheduler(self.ring, policy=_policy())
        else:
            self.sched = FiberScheduler(
                rings=self.rings, cores=self.cores, policy=_policy(),
                policies=[_policy() for _ in self.rings])
            self.sched.on_resume = self._note_resume
        # a ReplicatedCluster may attach the standby's ring/core to this
        # scheduler; the engine's own accounting must not absorb them
        self._own_rings = list(self.rings)
        self._own_cores = list(self.cores) if self.cores else None
        self.n_tuples = n_tuples

        # ---------------------------------------------- durability rung
        mode = _DURABILITY_MODES[cfg.durability]
        self.wal: Optional[WriteAheadLog] = None
        self.gc: Optional[GroupCommit] = None
        self.log_disk: Optional[SimDisk] = None
        self.committed: List[int] = []
        self.checkpoints = 0
        self._txn_ids = itertools.count(1)
        self._active_begin: Dict[int, int] = {}   # txn -> BEGIN lsn
        # per-key write-order tracking (ROADMAP: first step toward
        # OCC/latching): last COMMITTED writer per key and the commit
        # LSN that installed it — _apply's write-rule guard keeps live
        # state identical to a commit-order logical replay, and the
        # replication standby's applier re-derives the same map
        self.last_writer: Dict[int, int] = {}     # key -> txn id
        self._key_seq: Dict[int, int] = {}        # key -> commit LSN
        self.apply_skips = 0          # writes skipped by the write rule
        self.t_last_commit = 0.0      # when the last commit was acked
        # replication hook (repro.replication.ReplicatedCluster installs
        # it); None = single-node, zero overhead on every path
        self.repl = None
        if mode is not None:
            self.log_disk = SimDisk(
                self.tl, cfg.log_capacity, spec=spec,
                filesystem=(mode != "passthru"))
            if self.faults is not None:
                self.log_disk.faults = self.faults
            for r in self.rings:
                r.register_device(LOG_FD, self.log_disk)
            # NB: the partitioned pool rounds the frame count down to a
            # multiple of n_cores — the staging slots sit right after
            # the ACTUAL frames in the registered-buffer table
            self.wal = WriteAheadLog(
                self.ring, LOG_FD, self.log_disk, mode=mode,
                buf_base=self.pool.cfg.n_frames if cfg.fixed_bufs
                else None,
                header=LogHeader(root=root, next_pid=next_pid,
                                 page_size=cfg.page_size,
                                 value_size=cfg.value_size,
                                 data_capacity=len(disk.image)))
            if cfg.fixed_bufs:
                # one registered-buffer table: pool frames first, then
                # the WAL's 4 KiB-aligned staging slots — identical on
                # every ring, so a fixed-buffer SQE resolves the same
                # slot no matter which core issues it
                for r in self.rings:
                    r.register_buffers(self.pool.frames +
                                       self.wal.staging)
            self.pool.wal = self.wal
            if cfg.durability in ("group", "passthru-flush"):
                policy = AdaptiveFlush() if cfg.adaptive_commit else None
                signals = (lambda: (self.sched.inflight,
                                    self.sched.ready_count())) \
                    if policy is not None else None
                if self.mc:
                    self.gc = MultiCoreGroupCommit(
                        self.wal, n_cores=self.n_cores, sched=self.sched,
                        mode=mode, policy=policy, signals=signals)
                else:
                    self.gc = GroupCommit(self.wal, mode=mode,
                                          policy=policy, signals=signals)
        elif self.mc and cfg.fixed_bufs:
            # non-durable multi-core with registered buffers: the pool's
            # partitions skipped self-registration (ring=None)
            for r in self.rings:
                r.register_buffers(self.pool.frames)

    # ------------------------------------------------------ multi-core

    def _note_resume(self, fiber) -> None:
        """Scheduler hook: remember which core the running fiber is
        pinned to, for CPU charges (``charge``) and the partitioned
        pool's latch model."""
        self._cur_core = fiber.core
        self.pool.cur_core = fiber.core

    def charge(self, seconds: float) -> None:
        """Charge transaction-logic CPU to the calling fiber's core —
        the multi-core analogue of advancing the global clock (which is
        exactly what it degenerates to on one core)."""
        if self.mc:
            self.cores[self._cur_core].charge(self.tl.now, seconds)
        else:
            self.tl.run_until(self.tl.now + seconds)

    # ------------------------------------------------------ transactions

    def begin(self) -> Txn:
        return Txn(self, next(self._txn_ids))

    def commit(self, txn: Txn) -> Generator:
        """Make ``txn`` durable; suspends the calling fiber until its
        COMMIT record's LSN is covered by an fsync, then applies the
        write-set to the tree (deferred apply — see repro.wal)."""
        wal = self.wal
        if wal is None or txn.done:
            txn.done = True
            return
        txn.done = True
        if not txn.writes:                      # read-only: nothing to do
            return
        t0 = self.tl.now
        clsn = wal.append(encode_record(RecordType.COMMIT, txn.id))
        end = wal.end_lsn
        if self.gc is not None:
            # multi-core: enqueue on the calling core's commit queue
            # (the arg evaluates synchronously, before the first yield)
            yield from self.gc.commit(end, core=self._cur_core)
        else:                                   # +WAL: per-txn write+fsync
            yield from wal.flush_solo()
            wal.stats.groups.append(1)
        if self.repl is not None:
            # replicated rungs: the client ack additionally waits for
            # the standby (semisync: WAL-durable there; sync: applied
            # there; async: returns immediately)
            yield from self.repl.wait_commit(end)
        wal.stats.commits += 1
        wal.stats.commit_wait_s += self.tl.now - t0
        self.committed.append(txn.id)           # durable: ack the commit
        self.t_last_commit = self.tl.now
        yield from self._apply(txn, clsn)

    def abort(self, txn: Txn) -> Generator:
        txn.done = True
        if self.wal is not None and txn._began:
            self.wal.append(encode_record(RecordType.ABORT, txn.id))
            self._active_begin.pop(txn.id, None)
        txn.writes = []
        return
        yield                                   # (keeps this a generator)

    def _apply(self, txn: Txn, clsn: int = 0) -> Generator:
        """Apply the committed write-set to the B-tree.  Each tree op
        emits one APPLY record — physiological deltas for in-place leaf
        upserts, full page images for split-touched pages — and stamps
        the touched pages' LSNs, all inside the op's no-yield window so
        the snapshot is consistent.

        ``clsn`` (the txn's COMMIT record LSN) orders concurrent
        appliers per key: apply can suspend mid-write-set, so a
        later-committed txn may reach a shared key first — the write
        rule below skips the stale write instead of resurrecting it,
        making live state provably equal to recovery's commit-order
        logical replay (and to the replication standby's apply)."""
        wal, pool, tree = self.wal, self.pool, self.tree
        for key, value, rtype in txn.writes:
            if self._key_seq.get(key, -1) > clsn:
                self.apply_skips += 1           # a later committer won
                continue
            self._key_seq[key] = clsn
            self.last_writer[key] = txn.id
            ops = []                            # per-call oplog: fibers
            if rtype == RecordType.INSERT:      # suspend mid-traversal
                yield from tree.insert(key, value, oplog=ops)
            else:
                yield from tree.update(key, value, oplog=ops)
            # -- no suspension between here and the end of the loop body
            lsn = wal.end_lsn                   # LSN of the upcoming rec
            entries = []
            for op in ops:
                if op[0] == "upsert":
                    _, pid, k, v = op
                    idx = pool.table[pid]
                    pool.stamp_lsn(idx, lsn)
                    entries.append((APPLY_DELTA, pid, _kv_bytes(k, v)))
                else:                           # ("img", pid)
                    _, pid = op
                    idx = pool.table[pid]
                    pool.stamp_lsn(idx, lsn)
                    entries.append((APPLY_IMG, pid,
                                    bytes(pool.page(idx))))
            wal.append(encode_apply(txn.id, tree.root, tree.next_pid,
                                    entries))
        wal.append(encode_record(RecordType.APPLY_END, txn.id))
        # fully applied: recovery no longer needs this txn's intents
        # (its page effects redo from APPLY records / the page LSNs)
        self._active_begin.pop(txn.id, None)

    def checkpoint(self) -> Generator:
        """Flush-checkpoint: write back the currently-dirty pages (kept
        resident), then log root/next_pid + the residual dirty-page
        table and flush.  Transactions keep running throughout (fuzzy
        w.r.t. commits); the residual DPT only holds pages dirtied
        while the flush was in flight, so its min recLSN gives recovery
        a tight redo starting point."""
        wal = self.wal
        assert wal is not None
        # bounded passes: under a heavy write load new pages keep
        # dirtying while we flush — don't chase them forever
        max_passes = self.cfg.pool_frames // max(1,
                                                 self.cfg.evict_batch) + 4
        for _ in range(max_passes):
            n = yield from self.pool.clean_some()
            if n == 0:
                break
        dpt = self.pool.dirty_page_table()
        # txn-table snapshot: committed txns already fully applied —
        # their records may fall below a later truncation horizon, and
        # recovery must still count them as winners (ROADMAP: this is
        # what lets truncate_wal default on)
        applied = [t for t in self.committed
                   if t not in self._active_begin]
        ckpt_lsn = wal.append(encode_checkpoint(self.tree.root,
                                                self.tree.next_pid, dpt,
                                                committed=applied))
        yield from wal.flush_to(wal.end_lsn)
        self.checkpoints += 1
        if self.cfg.truncate_wal:
            # ROADMAP: the log device must stop growing unboundedly.
            # Everything below the redo horizon is dead weight: APPLY
            # records under the DPT's min recLSN have their effects on
            # disk, and any txn not yet fully applied pins the log at
            # its BEGIN record.
            horizon = min([ckpt_lsn] + list(dpt.values()) +
                          list(self._active_begin.values()))
            if self.repl is not None:
                # replication slot semantics: log bytes the standby has
                # not received yet must survive truncation — the sender
                # slices wal.buf, and zeroed spans would ship as garbage
                horizon = min(horizon, self.repl.ship_horizon())
            wal.header.root = self.tree.root
            wal.header.next_pid = self.tree.next_pid
            wal.truncate_to(horizon)

    # --------------------------------------------------------- metrics

    def register_metrics(self, reg, prefix: str = "engine",
                         txns=None) -> None:
        """Engine-wide stat surface for the telemetry sampler: every
        own ring's counters, the buffer pool's hit/fault surface, the
        group-commit queue, scheduler depth gauges, and — when
        ``txns`` supplies the completed-transaction counter — the
        windowed tps rate.  Pure reads; registration must not change
        scheduling (the zero-observer-effect pin covers this path)."""
        base = reg.unique(prefix)
        for i, r in enumerate(self._own_rings):
            r.register_metrics(reg, f"{base}/ring{i}")
        self.pool.register_metrics(reg, f"{base}/pool")
        if self.gc is not None:
            self.gc.register_metrics(reg, f"{base}/gc")
        reg.gauge(f"{base}/iodepth", lambda: self.sched.inflight)
        reg.gauge(f"{base}/ready_fibers", self.sched.ready_count)
        if self.faults is not None:
            self.faults.register_metrics(reg, f"{base}/faults")
        if txns is not None:
            reg.counter(f"{base}/txns", txns)
            reg.wrate(f"{base}/tps", txns, None, unit="txn/s")

    # ------------------------------------------------------ crash / run

    def crash_images(self) -> Tuple[bytes, bytes]:
        """Simulate power loss: freeze both device images as they are
        RIGHT NOW (in-flight writes included — the CRC framing and the
        commit protocol are what recovery relies on, not timing luck)."""
        assert self.log_disk is not None, "durability is off"
        return bytes(self.disk.image), bytes(self.log_disk.image)

    def run_fibers(self, make_txn, n_txns: int) -> dict:
        """Run n_txns transactions across cfg.n_fibers worker fibers
        (round-robin over the cores in multi-core mode).
        ``make_txn(rng)`` returns a fiber generator for one transaction."""
        rng = np.random.default_rng(1234)
        counter = {"done": 0}

        def worker():
            while counter["done"] < n_txns:
                counter["done"] += 1
                yield from make_txn(rng)

        mreg = _metrics.CURRENT
        if mreg is not None and getattr(self, "_mreg", None) is not mreg:
            # opt-in telemetry: register the whole stat surface once
            # per installed registry (repeat runs re-use the series)
            self._mreg = mreg
            self.register_metrics(mreg,
                                  txns=lambda: counter["done"])
        t0 = self.tl.now
        workers = []
        for i in range(self.cfg.n_fibers):
            if self.mc:
                c = i % self.n_cores
                workers.append(self.sched.spawn(
                    worker(), core=c,
                    ring=0 if self.cfg.shared_ring else c,
                    name=f"txn-worker{i}"))
            else:
                workers.append(self.sched.spawn(worker(),
                                                name=f"txn-worker{i}"))
        done = lambda: counter["done"] >= n_txns          # noqa: E731
        if self.wal is not None and self.cfg.ckpt_every > 0:
            self.sched.spawn(self._checkpointer(counter, n_txns),
                             name="checkpointer")
        self.spawn_service_fibers(workers, done)
        self.sched.run()
        # multi-core: the run ends when the last core drains, which may
        # be past the last timeline event
        end = self.tl.now if not self.mc else \
            max([self.tl.now] + [c.free for c in self._own_cores])
        dt = end - t0
        rs = self._ring_totals()
        out = {
            "config": self.cfg.name,
            "txns": counter["done"],
            "sim_seconds": dt,
            "tps": counter["done"] / dt if dt > 0 else float("inf"),
            "faults": self.pool.faults,
            "hits": self.pool.hits,
            "writebacks": self.pool.writebacks,
            "enters": rs["enters"],
            "batch_eff": rs["sqes"] / max(1, rs["enters"]),
            "worker_fallbacks": rs["worker_fallbacks"],
            "bounce_mb": rs["bounce_bytes"] / 1e6,
            "app_cpu_s": rs["cpu_app"],
            "sqpoll_cpu_s": rs["cpu_sqpoll"],
            # kernel-cost breakdown, merged over the engine's own rings;
            # conservation vs app_cpu_s+sqpoll_cpu_s is checked at bench
            # emission and by tests/test_observability.py
            "attribution": rs["attribution"],
        }
        if self.mc:
            out.update({
                "cores": self.n_cores,
                "shared_ring": self.cfg.shared_ring,
                "latch_cross": self.pool.latch_cross,
                "latch_local": self.pool.latch_local,
            })
        if self.wal is not None:
            ws = self.wal.stats
            out.update({
                "commits": ws.commits,
                "fsyncs": ws.fsyncs,
                "fsyncs_per_txn": ws.fsyncs / max(1, ws.commits),
                "group_size": ws.mean_group(),
                "commit_wait_us": ws.mean_commit_wait_s() * 1e6,
                "log_mb": ws.bytes_appended / 1e6,
                "wal_evict_waits": self.pool.wal_waits,
                "checkpoints": self.checkpoints,
                "truncations": ws.truncations,
                "log_reclaimed_mb": ws.bytes_reclaimed / 1e6,
                "log_live_mb": (self.wal.end_lsn -
                                self.wal.truncated_lsn) / 1e6,
            })
        if self.faults is not None:
            # fault-plane surfaces: injections by class tallied at the
            # plane, recoveries tallied where the policy lives
            out.update({
                "faults_injected": self.faults.total_injected,
                "error_cqes": sum(r.stats.error_cqes
                                  for r in self._own_rings),
                "short_cqes": sum(r.stats.short_cqes
                                  for r in self._own_rings),
                "passthru_fallbacks": sum(r.stats.passthru_fallbacks
                                          for r in self._own_rings),
                "pool_read_retries": self.pool.read_retries,
                "pool_write_retries": self.pool.write_retries,
            })
            if self.wal is not None:
                out.update({
                    "wal_io_retries": self.wal.stats.io_retries,
                    "wal_flush_errors": self.wal.stats.flush_errors,
                    "wal_passthru_degrades":
                        self.wal.stats.passthru_degrades,
                })
        if self.repl is not None:
            # with a standby attached, the run only quiesces once the
            # SHUTDOWN/fin handshake drains — report client-visible
            # throughput over the acked-commit horizon as well
            dt_ack = self.t_last_commit - t0
            out["tps_acked"] = counter["done"] / dt_ack if dt_ack > 0 \
                else out["tps"]
            out.update(self.repl.result_rows())
        return out

    def _ring_totals(self) -> dict:
        """Ring stats summed over the engine's OWN rings (one ring on
        one core is just the identity; an attached standby ring reports
        separately via the cluster)."""
        rings = self._own_rings
        attr: Dict[str, float] = {}
        for r in rings:
            for k, v in r.stats.attribution.items():
                attr[k] = attr.get(k, 0.0) + v
        return {
            "enters": sum(r.stats.enters for r in rings),
            "sqes": sum(r.stats.sqes_submitted for r in rings),
            "worker_fallbacks": sum(r.stats.worker_fallbacks
                                    for r in rings),
            "bounce_bytes": sum(r.stats.bounce_bytes_copied
                                for r in rings),
            "cpu_app": sum(r.stats.cpu_seconds_app for r in rings),
            "cpu_sqpoll": sum(r.stats.cpu_seconds_sqpoll
                              for r in rings),
            "attribution": attr,
        }

    def spawn_service_fibers(self, workers, done) -> None:
        """The background fiber complement shared by ``run_fibers`` and
        the open-loop SLO harness (``repro.observe.slo``): page
        cleaners, the multi-core WAL leader, and — on a replicated
        engine — the replication fibers.  ``done()`` is the workload's
        termination predicate; ``workers`` the worker fiber handles."""
        if self.wal is not None:
            if self.mc:
                # one background writer per core, cleaning its own pool
                # partition on its own ring
                for c in range(self.n_cores):
                    self.sched.spawn(
                        self.page_cleaner_part(c, stop=done), core=c,
                        ring=0 if self.cfg.shared_ring else c,
                        name=f"page-cleaner{c}")
            else:
                self.sched.spawn(self.page_cleaner(stop=done),
                                 name="page-cleaner")
        if isinstance(self.gc, MultiCoreGroupCommit):
            self.sched.spawn(self.gc.leader(
                stop=lambda: self.gc.pending == 0 and
                all(f.done for f in workers)), core=0, ring=0,
                name="wal-leader")
        if self.repl is not None:
            # replication fibers: primary log sender + ack receiver,
            # standby receiver/flusher/applier (repro.replication)
            self.repl.spawn_fibers(workers)

    def _checkpointer(self, counter, n_txns: int) -> Generator:
        last = 0
        every = self.cfg.ckpt_every
        while counter["done"] < n_txns:
            if len(self.committed) - last >= every:
                last = len(self.committed)
                yield from self.checkpoint()
            else:
                yield None

    def page_cleaner(self, stop=None) -> Generator:
        """Background writer: when the free list runs low, evict a batch
        (writing dirty pages back under WAL-before-data) so B-tree
        splits — which cannot suspend — always find a clean frame even
        when the whole working set is pool-resident."""
        pool = self.pool
        low = max(2 * pool.cfg.evict_batch, pool.cfg.n_frames // 16)
        while stop is None or not stop():
            if len(pool.free) < low:
                n = yield from pool.evict_some()
                if n == 0:
                    yield None
            else:
                yield None

    def page_cleaner_part(self, part_idx: int, stop=None) -> Generator:
        """Multi-core page cleaner: same policy as ``page_cleaner`` but
        scoped to one pool partition, running on that partition's core
        and issuing writebacks on that core's ring."""
        part = self.pool.parts[part_idx]
        low = max(2 * part.cfg.evict_batch, part.cfg.n_frames // 16)
        while stop is None or not stop():
            if len(part.free) < low:
                n = yield from part.evict_some()
                if n == 0:
                    yield None
            else:
                yield None


def _kv_bytes(key: int, value: bytes) -> bytes:
    """The <qH>key,vlen + value payload shared with the intent records
    (see repro.wal.log.decode_kv)."""
    return _struct.pack("<qH", key, len(value)) + value


def make_engine(cfg: EngineConfig, **kw):
    """Engine factory: dispatch on ``cfg.engine``.  Both engines share
    the transaction surface (begin / Txn.update / Txn.lookup / commit,
    ``run_fibers``, the SLO harness's service-fiber hooks), so
    workloads written against one run unchanged on the other.  The
    import is lazy: a B-tree config never touches repro.lsm."""
    if cfg.engine == "btree":
        return StorageEngine(cfg, **kw)
    if cfg.engine == "lsm":
        from repro_torch.lsm.engine import LSMEngine
        return LSMEngine(cfg, **kw)
    raise ValueError(f"unknown engine {cfg.engine!r}")
