"""Leveled compaction as background fibers on the shared ring runtime.

The **Manifest** is the in-memory table index: ``MAX_LEVELS`` levels,
L0 ordered newest-flush-first (tables may overlap), L1+ key-sorted and
disjoint.  Every mutation corresponds 1:1 to a durable WAL record
(LSM_FLUSH / LSM_COMPACT in ``repro.wal.log``) appended AFTER the new
tables' durability barrier, so recovery can rebuild exactly this state
(``repro.lsm.recovery``).

The **Compactor** is one background fiber sharing the foreground's ring
and core — the paper's background-I/O interference setting (§4.3: page
cleaners and compactions compete with OLTP for both device bandwidth
and CPU).  A job reads its input tables through batched ring
submissions, merges them (newest-wins per key), writes the outputs via
``TableIO`` and logs an LSM_COMPACT record before installing.

Merge CPU is charged in two modes:

* **host** (default): ``engine.charge`` in bounded slices with a
  cooperative yield between slices — the merge occupies the foreground
  core and visibly inflates the OLTP tail (the interference curve in
  benchmarks/bench_lsm.py).
* **kernel** (``+KernelCompaction``): the merge cycles plus the bounce
  copies of the table bytes are charged kernel-side via
  ``ring._charge(..., on_sqpoll=True, cat="kernel_compaction")`` — the
  eBPF-offload model: no fiber-core occupancy, the work shows up in
  ``cpu_seconds_sqpoll`` under its own attribution category, and only
  the device I/O still competes with the foreground.

**Compaction debt** is the byte count the leveling invariant says must
still move down (L0 backlog past the trigger + per-level overflow past
the level caps).  The engine integrates it over time; the advisor's
``compaction-debt`` rule and the interference benchmark key off it.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import Dict, Generator, List, Optional, Tuple

from repro_torch.core.fibers import IoRequest
from repro_torch.core.ring import prep_read, prep_timeout
from repro_torch.lsm.sstable import (SSTable, build_table_pages,
                                     decode_data_page, encode_compact_payload)
from repro_torch.wal.log import RecordType, encode_record

MAX_LEVELS = 4                       # L0 (overlapping) .. L3 (bottom)

#: entries merged per CPU slice in host mode — at the default
#: ``lsm_merge_entry`` cost one slice is ~1.7 ms of core time, long
#: enough to be visible in a foreground p99 but short enough that the
#: compactor stays cooperative.
MERGE_SLICE = 2048


class Manifest:
    """Live table index.  L0 is newest-first; L1+ are sorted by
    ``min_key`` and pairwise disjoint."""

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.levels: List[List[SSTable]] = [[] for _ in range(MAX_LEVELS)]
        self.by_id: Dict[int, SSTable] = {}

    # -- mutation ------------------------------------------------------

    def add_flush(self, t: SSTable) -> None:
        assert t.level == 0
        self.levels[0].insert(0, t)           # newest first
        self.by_id[t.id] = t

    def add_sorted(self, t: SSTable) -> None:
        lv = self.levels[t.level]
        lv.insert(bisect_right([x.min_key for x in lv], t.min_key), t)
        self.by_id[t.id] = t

    def install(self, removed_ids: List[int],
                added: List[SSTable]) -> List[SSTable]:
        """Apply one compaction edit; returns the removed handles (the
        engine reclaims their page ranges)."""
        out = []
        for tid in removed_ids:
            t = self.by_id.pop(tid)
            self.levels[t.level].remove(t)
            out.append(t)
        for t in added:
            if t.level == 0:
                self.add_flush(t)
            else:
                self.add_sorted(t)
        return out

    # -- queries -------------------------------------------------------

    def find(self, level: int, key: int) -> Optional[SSTable]:
        """The one table of a sorted level whose range covers ``key``."""
        lv = self.levels[level]
        if not lv:
            return None
        i = bisect_right([t.min_key for t in lv], key) - 1
        if i >= 0 and key <= lv[i].max_key:
            return lv[i]
        return None

    def overlapping(self, level: int, lo: int, hi: int) -> List[SSTable]:
        return [t for t in self.levels[level]
                if t.min_key <= hi and t.max_key >= lo]

    def level_bytes(self, level: int) -> int:
        return sum(t.data_bytes(self.page_size) for t in self.levels[level])

    def live_data_bytes(self) -> int:
        return sum(t.data_bytes(self.page_size) for t in self.by_id.values())

    def n_tables(self) -> int:
        return len(self.by_id)


class CompactionJob:
    __slots__ = ("inputs", "out_level")

    def __init__(self, inputs: List[SSTable], out_level: int):
        self.inputs = inputs
        self.out_level = out_level


class Compactor:
    """Background compaction fiber + the leveling policy.

    ``cap(i) = l0_trigger * memtable_bytes * fanout**(i-1)`` for
    1 <= i < MAX_LEVELS-1; the bottom level is uncapped (that is where
    the bulk-loaded dataset lives)."""

    def __init__(self, engine):
        self.e = engine
        cfg = engine.cfg
        self.l0_trigger = cfg.l0_trigger
        self.base_cap = cfg.l0_trigger * cfg.memtable_bytes
        self.fanout = cfg.level_fanout
        self.kernel = cfg.kernel_compaction
        self._cursor = [0] * MAX_LEVELS   # round-robin victim per level
        self.read_retries = 0
        self.jobs = 0
        self.bytes_in = 0
        self.bytes_out = 0

    # -- policy --------------------------------------------------------

    def cap(self, level: int) -> int:
        return self.base_cap * (self.fanout ** (level - 1))

    def debt_bytes(self) -> int:
        m = self.e.manifest
        d = 0
        if len(m.levels[0]) >= self.l0_trigger:
            d += m.level_bytes(0)
        for i in range(1, MAX_LEVELS - 1):
            d += max(0, m.level_bytes(i) - self.cap(i))
        return d

    def pick_job(self) -> Optional[CompactionJob]:
        m = self.e.manifest
        l0 = m.levels[0]
        if len(l0) >= self.l0_trigger:
            lo = min(t.min_key for t in l0)
            hi = max(t.max_key for t in l0)
            return CompactionJob(list(l0) + m.overlapping(1, lo, hi), 1)
        for i in range(1, MAX_LEVELS - 1):
            lv = m.levels[i]
            if lv and m.level_bytes(i) > self.cap(i):
                victim = lv[self._cursor[i] % len(lv)]
                self._cursor[i] += 1
                return CompactionJob(
                    [victim] + m.overlapping(i + 1, victim.min_key,
                                             victim.max_key), i + 1)
        return None

    # -- the fiber -----------------------------------------------------

    def run(self, stop) -> Generator:
        """Background fiber: drain debt until ``stop()`` holds."""
        while not stop():
            job = self.pick_job()
            if job is None:
                self.e.note_debt()
                yield None
                continue
            yield from self.run_job(job)
            self.e.note_debt()

    def run_job(self, job: CompactionJob) -> Generator:
        e = self.e
        ps = e.cfg.page_size
        entries_in, bytes_in = yield from self._read_inputs(job.inputs)
        merged = self._merge(job.inputs, entries_in)
        yield from self._charge_merge(sum(len(v) for v in entries_in),
                                      bytes_in)
        added: List[SSTable] = []
        out_bytes = 0
        for chunk in self._split(merged):
            pages, t = build_table_pages(
                chunk, page_size=ps, table_id=e.next_table_id(),
                seq=e.next_seq(), level=job.out_level,
                bloom_bits_per_key=e.cfg.bloom_bits_per_key)
            t.base_pid = e.alloc_pages(len(pages))
            yield from e.compact_io.write_table(t.base_pid, pages)
            out_bytes += len(pages) * ps
            added.append(t)
        removed_ids = [t.id for t in job.inputs]
        # tables are durable (barrier inside write_table) BEFORE the
        # manifest record that references them — a crash in between
        # leaves only orphaned page ranges, never a dangling reference
        e.wal.append(encode_record(RecordType.LSM_COMPACT, 0,
                                   encode_compact_payload(removed_ids,
                                                          added)))
        yield from e.wal.flush_to(e.wal.end_lsn)
        for old in e.manifest.install(removed_ids, added):
            e.free_pages(old)
        self.jobs += 1
        self.bytes_in += bytes_in
        self.bytes_out += out_bytes
        e.compacted_bytes += out_bytes

    # -- helpers -------------------------------------------------------

    def _read_inputs(self, inputs: List[SSTable]
                     ) -> Generator:
        """Read every input table's data pages in ONE batched submission
        (32 KiB chunks); transient read errors retry with the WAL
        backoff policy (reads are idempotent)."""
        from repro_torch.lsm.sstable import TableIO
        e = self.e
        ps = e.cfg.page_size
        cap = ps * TableIO.STAGING_BLOCKS
        plan = []                       # (table idx, offset, length)
        for ti, t in enumerate(inputs):
            nbytes = t.n_data * ps
            base = t.base_pid * ps
            for o in range(0, nbytes, cap):
                plan.append((ti, base + o, min(cap, nbytes - o)))
        bufs = [bytearray(n) for _, _, n in plan]
        req_ci: Dict[int, int] = {}

        def read_req(ci: int) -> IoRequest:
            _, off, n = plan[ci]

            def prep(sqe, ud, ci=ci, off=off, n=n):
                prep_read(sqe, e.compact_io.fd, bufs[ci], off, n)
                if e.compact_io.passthru:
                    sqe.cmd = "passthru"
                req_ci[ud] = ci
            return IoRequest(prep)

        pending = list(range(len(plan)))
        for attempt in range(TableIO.MAX_RETRIES + 1):
            req_ci.clear()
            cqes = yield [read_req(ci) for ci in pending]
            bad = [c for c in cqes
                   if c.res < 0 or c.res < plan[req_ci[c.user_data]][2]]
            if not bad:
                break
            pending = sorted(req_ci[c.user_data] for c in bad)
            if attempt >= TableIO.MAX_RETRIES:
                raise RuntimeError(
                    f"compaction read failed after {attempt + 1} attempts")
            self.read_retries += 1
            yield IoRequest(lambda sqe, ud, s=min(
                TableIO.BACKOFF_CAP,
                TableIO.BACKOFF_BASE * (2 ** attempt)):
                prep_timeout(sqe, s))

        entries_in: List[List[Tuple[int, bytes]]] = [[] for _ in inputs]
        for ci, (ti, _, n) in enumerate(plan):
            buf = bufs[ci]
            for po in range(0, n, ps):
                entries_in[ti].extend(decode_data_page(buf[po:po + ps]))
        return entries_in, sum(n for _, _, n in plan)

    @staticmethod
    def _merge(inputs: List[SSTable],
               entries_in: List[List[Tuple[int, bytes]]]
               ) -> List[Tuple[int, bytes]]:
        """Newest-wins merge.  Precedence: lower level = newer; within
        L0, higher flush ``seq`` = newer.  Updating a dict oldest→newest
        leaves exactly the newest value per key."""
        order = sorted(range(len(inputs)),
                       key=lambda i: (-inputs[i].level, inputs[i].seq))
        d: Dict[int, bytes] = {}
        for i in order:
            d.update(entries_in[i])
        return sorted(d.items())

    def _split(self, merged: List[Tuple[int, bytes]]
               ) -> List[List[Tuple[int, bytes]]]:
        from repro_torch.lsm.memtable import ENTRY_HDR
        cap = self.e.cfg.sstable_bytes
        out, cur, cur_b = [], [], 0
        for k, v in merged:
            n = ENTRY_HDR + len(v)
            if cur and cur_b + n > cap:
                out.append(cur)
                cur, cur_b = [], 0
            cur.append((k, v))
            cur_b += n
        if cur:
            out.append(cur)
        return out

    def _charge_merge(self, n_entries: int, n_bytes: int) -> Generator:
        """Charge the merge CPU: host mode on the foreground core in
        cooperative slices; kernel mode entirely kernel-side (merge
        cycles + bounce copies), with zero fiber-core occupancy."""
        e = self.e
        cm = e.ring.costs
        cycles = n_entries * cm.lsm_merge_entry
        if self.kernel:
            e.ring._charge(cycles + cm.copy_cycles(2 * n_bytes),
                           True, "kernel_compaction", "rw")
            e.compaction_cpu_s += cm.s(cycles)
            return
        done = 0
        while done < n_entries:
            step = min(MERGE_SLICE, n_entries - done)
            e.charge(cm.s(step * cm.lsm_merge_entry))
            e.compaction_cpu_s += cm.s(step * cm.lsm_merge_entry)
            done += step
            yield None                 # let foreground fibers in
