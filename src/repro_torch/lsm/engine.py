"""LSM storage engine on the ring runtime.

Same commit/lookup surface as ``repro.storage.StorageEngine`` (begin /
Txn.update / Txn.lookup / commit, ``run_fibers``, the open-loop SLO
harness's service-fiber hooks), but the store is a log-structured
merge tree instead of an update-in-place B-tree:

* writes buffer in a **memtable** (``repro.lsm.memtable``), durable the
  moment their WAL COMMIT record is (the same group-commit machinery,
  verbatim — the WAL subsystem is reused, not re-implemented);
* a full memtable rotates and a background **flusher** fiber writes it
  as an L0 **SSTable** through the ring (``repro.lsm.sstable``:
  batched submissions, registered staging buffers, ``+Passthru``);
* a background **compactor** fiber (``repro.lsm.compaction``) keeps
  the leveling invariant, sharing the foreground's ring and core —
  the interference the paper warns about, measurable here, with the
  ``+KernelCompaction`` rung moving the merge CPU kernel-side;
* lookups go memtable → immutable memtables → L0 (newest first) →
  the sorted levels, bloom filters and fence pointers bounding the
  device probes; per-level probe counts land in
  ``RingStats.lsm_level_reads`` (the read-amplification surface).

Durability is mandatory (an LSM without a WAL loses its memtable), and
the engine is single-core: one ring, foreground and background fibers
in the same submission loop — exactly the setting where background
interference is visible and attributable.

Crash consistency: SSTables are only referenced by a WAL manifest
record (LSM_FLUSH / LSM_COMPACT) appended AFTER the table's durability
barrier, each LSM_FLUSH carries the **replay horizon** — the lowest
COMMIT LSN whose effects are NOT fully contained in flushed tables —
and recovery (``repro.lsm.recovery``) replays committed transactions
from the newest valid horizon over the reconstructed tables.
"""

from __future__ import annotations

import itertools
from typing import Dict, Generator, List, Optional, Tuple

import numpy as np

from repro_torch.bufferpool import BufferPool, PoolConfig
from repro_torch.core import (AdaptiveBatcher, AdaptiveFlush, EagerSubmit,
                              FiberScheduler, IoUring, NVMeSpec, SetupFlags,
                              Timeline)
from repro_torch.core.backends import LOG_FD, LSM_FD, SimDisk
from repro_torch.core.faults import maybe_plane
from repro_torch.lsm.compaction import MAX_LEVELS, Compactor, Manifest
from repro_torch.lsm.memtable import ENTRY_HDR, Memtable
from repro_torch.lsm.sstable import (TableIO, build_table_pages,
                                     encode_compact_payload,
                                     encode_flush_payload, search_page)
from repro_torch.observe import metrics as _metrics
from repro_torch.wal.group_commit import GroupCommit
from repro_torch.wal.log import (LogHeader, RecordType, WriteAheadLog,
                                 encode_kv, encode_record)
from repro_torch.storage.engine import _DURABILITY_MODES, EngineConfig


class LSMTxn:
    """Transaction handle: redo-only intents into the WAL, write-set
    buffered until commit (identical protocol to the B-tree engine's
    ``Txn`` — only the apply target differs)."""

    __slots__ = ("engine", "id", "writes", "_began", "done")

    def __init__(self, engine: "LSMEngine", txn_id: int):
        self.engine = engine
        self.id = txn_id
        self.writes: List[Tuple[int, bytes, int]] = []
        self._began = False
        self.done = False

    def lookup(self, key: int) -> Generator:
        for k, v, _ in reversed(self.writes):     # read-your-writes
            if k == key:
                return v
        out = yield from self.engine.lookup(key)
        return out

    def update(self, key: int, value: bytes) -> Generator:
        self._intent(RecordType.UPDATE, key, value)
        return True
        yield                                     # pragma: no cover

    def insert(self, key: int, value: bytes) -> Generator:
        self._intent(RecordType.INSERT, key, value)
        return True
        yield                                     # pragma: no cover

    def _intent(self, rtype: int, key: int, value: bytes) -> None:
        wal = self.engine.wal
        if not self._began:
            wal.append(encode_record(RecordType.BEGIN, self.id))
            self._began = True
        wal.append(encode_kv(rtype, self.id, key, value))
        self.writes.append((key, value, rtype))


class LSMEngine:
    """Timeline + ring + pool + memtable/SSTables + WAL."""

    def __init__(self, cfg: EngineConfig, *, n_tuples: int = 200_000,
                 spec: Optional[NVMeSpec] = None, seed: int = 0):
        assert cfg.n_cores == 1, "the LSM engine is single-core"
        mode = _DURABILITY_MODES[cfg.durability]
        assert mode is not None, \
            "the LSM engine requires a durable rung (memtable = WAL)"
        self.cfg = cfg
        self.tl = Timeline()
        self.n_cores = 1
        self.mc = False
        setup = SetupFlags.SINGLE_ISSUER | SetupFlags.DEFER_TASKRUN
        if cfg.iopoll:
            setup |= SetupFlags.IOPOLL
        if cfg.sqpoll:
            setup |= SetupFlags.SQPOLL
        self._cur_core = 0
        self.ring = IoUring(self.tl, sq_depth=512, setup=setup)
        self.rings = [self.ring]
        self._own_rings = [self.ring]
        self._own_cores = None
        self.cores = None

        # ---------------------------------------------- initial dataset
        # same seeded values as StorageEngine's bulk_load, so the two
        # engines start from identical logical state (the equivalence
        # tests depend on this)
        rng = np.random.default_rng(seed)
        vals = rng.integers(0, 256, (n_tuples, cfg.value_size),
                            dtype=np.uint8)
        self.n_tuples = n_tuples
        self.manifest = Manifest(cfg.page_size)
        self._table_ids = itertools.count(1)
        self._seqs = itertools.count(1)
        entries = [(int(k), vals[k].tobytes()) for k in range(n_tuples)]
        pages_out: List[Tuple[int, List[bytes]]] = []   # (base_pid, pages)
        next_pid = 0
        for chunk in _split_entries(entries, cfg.sstable_bytes):
            pages, t = build_table_pages(
                chunk, page_size=cfg.page_size,
                table_id=next(self._table_ids), seq=next(self._seqs),
                level=MAX_LEVELS - 1,
                bloom_bits_per_key=cfg.bloom_bits_per_key)
            t.base_pid = next_pid
            pages_out.append((next_pid, pages))
            next_pid += len(pages)
            self.manifest.add_sorted(t)
        init_bytes = next_pid * cfg.page_size
        spec = spec or NVMeSpec()
        disk = SimDisk(self.tl, init_bytes * 3 + 32 * 1024 * 1024,
                       spec=spec, filesystem=not cfg.passthrough)
        self.disk = disk
        ps = cfg.page_size
        for base_pid, pages in pages_out:
            off = base_pid * ps
            disk.image[off:off + len(pages) * ps] = b"".join(pages)
        self.next_pid = next_pid
        self._free_ranges: List[Tuple[int, int]] = []   # (start, n)
        self.leaked_pages = 0

        self.faults = maybe_plane(cfg.faults)
        if self.faults is not None:
            disk.faults = self.faults
        self.ring.register_device(LSM_FD, disk)

        pcfg = PoolConfig(
            n_frames=cfg.pool_frames, page_size=cfg.page_size,
            batch_evict=cfg.batch_evict, evict_batch=cfg.evict_batch,
            fixed_bufs=cfg.fixed_bufs, passthrough=cfg.passthrough,
            fd=LSM_FD)
        self.pool = BufferPool(self.ring, pcfg)
        self.sched = FiberScheduler(
            self.ring,
            policy=AdaptiveBatcher() if cfg.adaptive_batch
            else EagerSubmit())

        # ---------------------------------------------------------- WAL
        self.log_disk = SimDisk(self.tl, cfg.log_capacity, spec=spec,
                                filesystem=(mode != "passthru"))
        if self.faults is not None:
            self.log_disk.faults = self.faults
        self.ring.register_device(LOG_FD, self.log_disk)
        self.wal = WriteAheadLog(
            self.ring, LOG_FD, self.log_disk, mode=mode,
            buf_base=cfg.pool_frames if cfg.fixed_bufs else None,
            header=LogHeader(root=0, next_pid=next_pid,
                             page_size=cfg.page_size,
                             value_size=cfg.value_size,
                             data_capacity=len(disk.image)))
        # bootstrap manifest: one LSM_COMPACT record referencing the
        # bulk-loaded bottom-level tables goes straight into the log
        # image (exactly like the header block) so recovery after a
        # crash-before-first-flush still finds the initial dataset
        self.wal.append(encode_record(
            RecordType.LSM_COMPACT, 0,
            encode_compact_payload(
                [], [t for lv in self.manifest.levels for t in lv])))
        boot_end = self.wal.end_lsn
        self.log_disk.image[:boot_end] = self.wal.buf
        self.wal.durable_lsn = boot_end
        self.wal.flushed_lsn = boot_end
        # two write paths, each owned by exactly one background fiber:
        # sharing staging slots between the flusher and the compactor
        # would let one overwrite the other's in-flight data
        base = cfg.pool_frames + WriteAheadLog.N_STAGING
        self.table_io = TableIO(
            self.ring, LSM_FD, cfg.page_size,
            buf_base=base if cfg.fixed_bufs else None,
            passthru=cfg.passthrough)
        self.compact_io = TableIO(
            self.ring, LSM_FD, cfg.page_size,
            buf_base=(base + TableIO.N_STAGING) if cfg.fixed_bufs
            else None,
            passthru=cfg.passthrough)
        if cfg.fixed_bufs:
            # ONE registered table: pool frames, then the WAL staging
            # slots, then the flusher's, then the compactor's
            self.ring.register_buffers(self.pool.frames +
                                       self.wal.staging +
                                       self.table_io.staging +
                                       self.compact_io.staging)
        self.gc: Optional[GroupCommit] = None
        if cfg.durability in ("group", "passthru-flush"):
            policy = AdaptiveFlush() if cfg.adaptive_commit else None
            signals = (lambda: (self.sched.inflight,
                                self.sched.ready_count())) \
                if policy is not None else None
            self.gc = GroupCommit(self.wal, mode=mode, policy=policy,
                                  signals=signals)

        # ------------------------------------------------- LSM runtime
        self.active = Memtable()
        self.immutables: List[Tuple[Memtable, int]] = []  # (mt, horizon)
        self.compactor = Compactor(self)
        self._txn_ids = itertools.count(1)
        self._unapplied: Dict[int, int] = {}     # txn -> COMMIT lsn
        self.committed: List[int] = []
        self.t_last_commit = 0.0
        self.repl = None                         # surface parity only
        self.apply_skips = 0
        self.lookups = 0
        self.mem_hits = 0
        self.user_bytes = 0
        self.flushed_bytes = 0
        self.compacted_bytes = 0
        self.compaction_cpu_s = 0.0
        self.flushes = 0
        self._debt_d = 0
        self._debt_t = 0.0
        self._debt_integral = 0.0
        self.debt_max = 0

    # -------------------------------------------------------- pid space

    def alloc_pages(self, n: int) -> int:
        """Contiguous page range for a new table: first-fit from freed
        compaction inputs, else bump allocation (bounded by the device
        image — a clear error beats silent wraparound)."""
        for i, (start, have) in enumerate(self._free_ranges):
            if have >= n:
                if have == n:
                    self._free_ranges.pop(i)
                else:
                    self._free_ranges[i] = (start + n, have - n)
                return start
        pid = self.next_pid
        if (pid + n) * self.cfg.page_size > len(self.disk.image):
            raise RuntimeError("LSM device image exhausted")
        self.next_pid += n
        return pid

    def free_pages(self, table) -> None:
        """Reclaim a removed table's range, dropping any cached pages
        from the pool first (a reused pid must never serve stale
        frames).  A range with a pinned/in-flight frame is leaked — a
        concurrent probe may still be reading the old table."""
        pool = self.pool
        clean = True
        for pid in range(table.base_pid, table.base_pid + table.n_pages):
            idx = pool.table.get(pid)
            if idx is None:
                continue
            m = pool.meta[idx]
            if m.pins > 0 or m.loading:
                clean = False
                continue
            pool.table.pop(pid)
            m.pid = -1
            m.ref = False
            m.dirty = False
            pool.free.append(idx)
        if clean:
            self._free_ranges.append((table.base_pid, table.n_pages))
        else:
            self.leaked_pages += table.n_pages

    def next_table_id(self) -> int:
        return next(self._table_ids)

    def next_seq(self) -> int:
        return next(self._seqs)

    # ------------------------------------------------------------ debt

    def note_debt(self) -> None:
        """Sample the compaction-debt curve (time-weighted integral +
        max); called at every debt-changing event."""
        now = self.tl.now
        self._debt_integral += self._debt_d * (now - self._debt_t)
        self._debt_t = now
        self._debt_d = self.compactor.debt_bytes()
        self.debt_max = max(self.debt_max, self._debt_d)

    # ----------------------------------------------------- transactions

    def charge(self, seconds: float) -> None:
        self.tl.run_until(self.tl.now + seconds)

    def begin(self) -> LSMTxn:
        return LSMTxn(self, next(self._txn_ids))

    def commit(self, txn: LSMTxn) -> Generator:
        """Append COMMIT, wait until it is durable, then install the
        write-set in the memtable (deferred apply, same protocol as the
        B-tree engine — the apply target is a dict put instead of a
        tree traversal)."""
        wal = self.wal
        if txn.done:
            return
        txn.done = True
        if not txn.writes:
            return
        t0 = self.tl.now
        clsn = wal.append(encode_record(RecordType.COMMIT, txn.id))
        end = wal.end_lsn
        # committed-but-unapplied: rotation's replay-horizon must keep
        # this txn's records replayable until its memtable install
        self._unapplied[txn.id] = clsn
        if self.gc is not None:
            yield from self.gc.commit(end)
        else:
            yield from wal.flush_solo()
            wal.stats.groups.append(1)
        wal.stats.commits += 1
        wal.stats.commit_wait_s += self.tl.now - t0
        self.committed.append(txn.id)
        self.t_last_commit = self.tl.now
        # apply: no suspension points — the write-set installs atomically
        mt = self.active
        for key, value, _ in txn.writes:
            if not mt.put(key, value, clsn):
                self.apply_skips += 1            # a later committer won
            self.user_bytes += ENTRY_HDR + len(value)
        del self._unapplied[txn.id]
        if mt.approx_bytes >= self.cfg.memtable_bytes:
            self._rotate()

    def abort(self, txn: LSMTxn) -> Generator:
        txn.done = True
        if txn._began:
            self.wal.append(encode_record(RecordType.ABORT, txn.id))
        txn.writes = []
        return
        yield                                     # pragma: no cover

    def _rotate(self) -> None:
        """Seal the active memtable for flushing.  The captured replay
        horizon is the lowest LSN recovery still needs once this
        memtable's table is durable: everything below ``end_lsn`` is
        either applied into a sealed-or-flushed memtable or belongs to
        a committed-but-unapplied txn, whose COMMIT LSN bounds it."""
        horizon = min([self.wal.end_lsn] + list(self._unapplied.values()))
        self.immutables.append((self.active, horizon))
        self.active = Memtable()
        self.note_debt()

    # --------------------------------------------------------- lookups

    def lookup(self, key: int) -> Generator:
        """Point lookup: memtable, immutable memtables (newest first),
        L0 newest-flush-first, then the one candidate table per sorted
        level — bloom filters and fence pointers prune device probes,
        which go through the buffer pool (cached pages are hits like
        any other)."""
        self.lookups += 1
        hit = self.active.get(key)
        if hit is None:
            for mt, _ in reversed(self.immutables):
                hit = mt.get(key)
                if hit is not None:
                    break
        if hit is not None:
            self.mem_hits += 1
            return hit[0]
        st = self.ring.stats
        for t in list(self.manifest.levels[0]):
            if key < t.min_key or key > t.max_key:
                continue
            if not t.may_contain(key):
                st.lsm_bloom_skips += 1
                continue
            v = yield from self._probe(t, key, "L0")
            if v is not None:
                return v
        for li in range(1, MAX_LEVELS):
            t = self.manifest.find(li, key)
            if t is None:
                continue
            if not t.may_contain(key):
                st.lsm_bloom_skips += 1
                continue
            v = yield from self._probe(t, key, f"L{li}")
            if v is not None:
                return v
        return None

    def _probe(self, t, key: int, level: str) -> Generator:
        idx = yield from self.pool.fix(t.page_pid_for(key))
        st = self.ring.stats
        st.lsm_level_reads[level] = st.lsm_level_reads.get(level, 0) + 1
        v = search_page(self.pool.page(idx), key)
        self.pool.unfix(idx)
        return v

    # ----------------------------------------------------- background

    def flusher(self, stop) -> Generator:
        """Background fiber: drain sealed memtables to L0, oldest
        first (horizons must reach the manifest in WAL order)."""
        while not stop():
            if self.immutables:
                mt, horizon = self.immutables[0]
                yield from self._flush_one(mt, horizon)
                self.immutables.pop(0)
                self.note_debt()
            else:
                yield None

    def _flush_one(self, mt: Memtable, horizon: int) -> Generator:
        entries = list(mt.sorted_entries())
        if not entries:
            return
        cm = self.ring.costs
        # serialization is host work in either compaction mode (the
        # offload rung moves merges, not memtable flushes)
        self.charge(cm.s(len(entries) * cm.lsm_merge_entry // 2))
        pages, t = build_table_pages(
            entries, page_size=self.cfg.page_size,
            table_id=self.next_table_id(), seq=self.next_seq(), level=0,
            bloom_bits_per_key=self.cfg.bloom_bits_per_key)
        t.base_pid = self.alloc_pages(len(pages))
        yield from self.table_io.write_table(t.base_pid, pages)
        # table durable -> now the manifest record may reference it
        self.wal.append(encode_record(RecordType.LSM_FLUSH, 0,
                                      encode_flush_payload(horizon, t)))
        yield from self.wal.flush_to(self.wal.end_lsn)
        self.manifest.add_flush(t)
        self.flushes += 1
        self.flushed_bytes += len(pages) * self.cfg.page_size

    def spawn_service_fibers(self, workers, done) -> None:
        """Flusher + compactor — the background complement the SLO
        harness and ``run_fibers`` both need.  They stop with the
        workload: unflushed memtables still serve reads from memory
        and stay recoverable from the WAL."""
        self.sched.spawn(self.flusher(stop=done), name="lsm-flusher")
        self.sched.spawn(self.compactor.run(stop=done),
                         name="lsm-compactor")

    # ------------------------------------------------------ crash / run

    def crash_images(self) -> Tuple[bytes, bytes]:
        """Power loss NOW: both device images, in-flight writes
        included."""
        return bytes(self.disk.image), bytes(self.log_disk.image)

    def register_metrics(self, reg, prefix: str = "lsm",
                         txns=None) -> None:
        base = reg.unique(prefix)
        self.ring.register_metrics(reg, f"{base}/ring0")
        self.pool.register_metrics(reg, f"{base}/pool")
        if self.gc is not None:
            self.gc.register_metrics(reg, f"{base}/gc")
        reg.gauge(f"{base}/iodepth", lambda: self.sched.inflight)
        reg.gauge(f"{base}/ready_fibers", self.sched.ready_count)
        reg.gauge(f"{base}/debt_bytes", self.compactor.debt_bytes)
        reg.gauge(f"{base}/l0_tables",
                  lambda: len(self.manifest.levels[0]))
        reg.gauge(f"{base}/memtable_bytes",
                  lambda: self.active.approx_bytes)
        if self.faults is not None:
            self.faults.register_metrics(reg, f"{base}/faults")
        if txns is not None:
            reg.counter(f"{base}/txns", txns)
            reg.wrate(f"{base}/tps", txns, None, unit="txn/s")

    def run_fibers(self, make_txn, n_txns: int) -> dict:
        """Closed-loop run: cfg.n_fibers worker fibers, the flusher and
        the compactor sharing the one ring/core.  Result rows mirror
        ``StorageEngine.run_fibers`` plus the LSM surface."""
        rng = np.random.default_rng(1234)
        counter = {"done": 0}

        def worker():
            while counter["done"] < n_txns:
                counter["done"] += 1
                yield from make_txn(rng)

        mreg = _metrics.CURRENT
        if mreg is not None and getattr(self, "_mreg", None) is not mreg:
            self._mreg = mreg
            self.register_metrics(mreg, txns=lambda: counter["done"])
        t0 = self.tl.now
        workers = [self.sched.spawn(worker(), name=f"txn-worker{i}")
                   for i in range(self.cfg.n_fibers)]
        done = lambda: counter["done"] >= n_txns          # noqa: E731
        self.spawn_service_fibers(workers, done)
        self.sched.run()
        self.note_debt()
        dt = self.tl.now - t0
        rs = self.ring.stats
        ws = self.wal.stats
        out = {
            "config": self.cfg.name,
            "engine": "lsm",
            "txns": counter["done"],
            "sim_seconds": dt,
            "tps": counter["done"] / dt if dt > 0 else float("inf"),
            "faults": self.pool.faults,
            "hits": self.pool.hits,
            "writebacks": self.pool.writebacks,
            "enters": rs.enters,
            "batch_eff": rs.sqes_submitted / max(1, rs.enters),
            "worker_fallbacks": rs.worker_fallbacks,
            "bounce_mb": rs.bounce_bytes_copied / 1e6,
            "app_cpu_s": rs.cpu_seconds_app,
            "sqpoll_cpu_s": rs.cpu_seconds_sqpoll,
            "attribution": dict(rs.attribution),
            "commits": ws.commits,
            "fsyncs": ws.fsyncs,
            "fsyncs_per_txn": ws.fsyncs / max(1, ws.commits),
            "group_size": ws.mean_group(),
            "commit_wait_us": ws.mean_commit_wait_s() * 1e6,
            "log_mb": ws.bytes_appended / 1e6,
        }
        out.update(self.lsm_result_rows(dt))
        if self.faults is not None:
            out.update({
                "faults_injected": self.faults.total_injected,
                "error_cqes": rs.error_cqes,
                "short_cqes": rs.short_cqes,
                "passthru_fallbacks": rs.passthru_fallbacks,
                "pool_read_retries": self.pool.read_retries,
                "pool_write_retries": self.pool.write_retries,
                "wal_io_retries": ws.io_retries,
                "wal_flush_errors": ws.flush_errors,
                "wal_passthru_degrades": ws.passthru_degrades,
                "sst_write_retries": self.table_io.write_retries +
                self.compact_io.write_retries,
                "compaction_read_retries": self.compactor.read_retries,
            })
        return out

    def lsm_result_rows(self, dt: float) -> dict:
        """The LSM-specific result surface (shared by the closed-loop
        runner and the open-loop benchmark)."""
        st = self.ring.stats
        disk_probes = sum(st.lsm_level_reads.values())
        logical = self.n_tuples * (ENTRY_HDR + self.cfg.value_size)
        mem_bytes = self.active.approx_bytes + \
            sum(mt.approx_bytes for mt, _ in self.immutables)
        return {
            "flushes": self.flushes,
            "compactions": self.compactor.jobs,
            "flushed_mb": self.flushed_bytes / 1e6,
            "compacted_mb": self.compacted_bytes / 1e6,
            "write_amp": (self.flushed_bytes + self.compacted_bytes)
            / max(1, self.user_bytes),
            "lookups": self.lookups,
            "read_amp": disk_probes / max(1, self.lookups),
            "space_amp": (self.manifest.live_data_bytes() + mem_bytes)
            / max(1, logical),
            "mem_hit_frac": self.mem_hits / max(1, self.lookups),
            "bloom_skips": st.lsm_bloom_skips,
            "level_reads": dict(st.lsm_level_reads),
            "apply_skips": self.apply_skips,
            "compaction_cpu_s": self.compaction_cpu_s,
            "compaction_cpu_frac": self.compaction_cpu_s / dt
            if dt > 0 else 0.0,
            "debt_mean_mb": (self._debt_integral / dt if dt > 0
                             else 0.0) / 1e6,
            "debt_max_mb": self.debt_max / 1e6,
            "kernel_compaction": self.cfg.kernel_compaction,
            "n_tables": self.manifest.n_tables(),
            "leaked_pages": self.leaked_pages,
        }


def _split_entries(entries, cap_bytes: int):
    """Split sorted entries into SSTable-sized chunks (shared with the
    compactor's output splitting)."""
    out, cur, cur_b = [], [], 0
    for k, v in entries:
        n = ENTRY_HDR + len(v)
        if cur and cur_b + n > cap_bytes:
            out.append(cur)
            cur, cur_b = [], 0
        cur.append((k, v))
        cur_b += n
    if cur:
        out.append(cur)
    return out
