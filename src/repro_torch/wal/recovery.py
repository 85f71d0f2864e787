"""ARIES-lite crash recovery: analysis → page redo → logical redo.

``recover(data_image, log_image)`` rebuilds a queryable engine from the
two crashed device images:

1. **Analysis** scans the whole log (it is a simulation; the log fits in
   memory).  Winners are txns with a durable COMMIT record; txns with an
   ABORT record or no COMMIT are losers and are simply ignored — the
   deferred-apply protocol guarantees a loser never touched the tree.
   The last CHECKPOINT (root/next_pid + dirty-page table) is located.

2. **Page redo** replays APPLY records in LSN order through the buffer
   pool.  Each entry is guarded by the on-page LSN (physiological redo):
   a page whose LSN already covers the record was flushed after the
   change and is skipped; otherwise the delta/image is applied and the
   page LSN advanced.  Root/next_pid track the latest APPLY record.

3. **Logical redo** re-runs the UPDATE/INSERT intents of every winner
   whose APPLY records are incomplete (no APPLY_END — the crash hit
   between commit-durable and apply-durable) as ordinary idempotent
   B-tree upserts, in commit order.

The recovered engine is a plain ``FiberScheduler`` + pool + tree over a
fresh timeline, so tests and tools can run verification fibers on it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.bufferpool import BufferPool, PoolConfig
from repro_torch.core import (FiberScheduler, IoUring, NVMeSpec, SetupFlags,
                              Timeline)
from repro_torch.core.backends import SimDisk
from repro_torch.storage.btree import BTree, _Node, set_page_lsn
from repro_torch.wal.log import (APPLY_DELTA, APPLY_IMG, LogRecord, RecordType,
                                 decode_apply, decode_checkpoint, decode_kv,
                                 read_header, scan_log)


@dataclass
class RecoveryReport:
    records: int = 0
    winners: Set[int] = field(default_factory=set)
    losers: Set[int] = field(default_factory=set)
    aborted: Set[int] = field(default_factory=set)
    apply_records: int = 0
    applies_before_ckpt: int = 0      # skipped whole: LSN < min recLSN
    pages_redone: int = 0
    pages_skipped: int = 0            # page LSN already covered the record
    logically_replayed: int = 0       # winners completed from intents
    checkpoint_lsn: Optional[int] = None
    redo_start: int = 0               # min recLSN of the last checkpoint
    dpt_size: int = 0
    truncated_lsn: int = 0            # log reclaimed below this LSN


class RecoveredEngine:
    """Minimal engine (timeline + ring + pool + tree) over the crashed
    data image, with helpers to run verification fibers."""

    def __init__(self, data_image: bytes, *, page_size: int,
                 value_size: int, root: int, next_pid: int,
                 pool_frames: int = 4096, spec: Optional[NVMeSpec] = None):
        self.tl = Timeline()
        self.ring = IoUring(self.tl, sq_depth=512,
                            setup=(SetupFlags.SINGLE_ISSUER |
                                   SetupFlags.DEFER_TASKRUN))
        self.disk = SimDisk(self.tl, len(data_image),
                            spec=spec or NVMeSpec(), filesystem=True)
        self.disk.image[:] = data_image
        self.ring.register_device(3, self.disk)
        self.pool = BufferPool(self.ring, PoolConfig(
            n_frames=pool_frames, page_size=page_size, fd=3,
            fixed_bufs=False))
        self.tree = BTree(self.pool, root, next_pid,
                          value_size=value_size)
        self.sched = FiberScheduler(self.ring)

    def run(self, gen) -> object:
        """Run one fiber to completion, returning its value."""
        f = self.sched.spawn(gen)
        self.sched.run()
        return f.value

    def get(self, key: int) -> Optional[bytes]:
        return self.run(self.tree.lookup(key))

    def get_many(self, keys) -> Dict[int, Optional[bytes]]:
        out: Dict[int, Optional[bytes]] = {}

        def probe():
            for k in keys:
                out[k] = yield from self.tree.lookup(k)
        self.run(probe())
        return out


def analyze(records: List[LogRecord]):
    """Sort the log into winners/losers/aborted + per-txn intents."""
    commit_lsn: Dict[int, int] = {}
    aborted: Set[int] = set()
    seen: Set[int] = set()
    intents: Dict[int, List[Tuple[int, int, bytes]]] = {}
    apply_done: Set[int] = set()
    ckpt: Optional[LogRecord] = None
    for r in records:
        if r.type in (RecordType.BEGIN, RecordType.UPDATE,
                      RecordType.INSERT, RecordType.COMMIT,
                      RecordType.ABORT):
            seen.add(r.txn)
        if r.type in (RecordType.UPDATE, RecordType.INSERT):
            key, value = decode_kv(r.payload)
            intents.setdefault(r.txn, []).append((r.type, key, value))
        elif r.type == RecordType.COMMIT:
            commit_lsn[r.txn] = r.lsn
        elif r.type == RecordType.ABORT:
            aborted.add(r.txn)
        elif r.type == RecordType.APPLY_END:
            apply_done.add(r.txn)
        elif r.type == RecordType.CHECKPOINT:
            ckpt = r
    losers = (seen - set(commit_lsn)) | aborted
    return commit_lsn, losers, aborted, intents, apply_done, ckpt


def recover(data_image: bytes, log_image: bytes, *,
            pool_frames: int = 4096, spec: Optional[NVMeSpec] = None,
            full_redo: bool = False
            ) -> Tuple[RecoveredEngine, RecoveryReport]:
    """``full_redo``: ignore the checkpoint's redo bound and replay every
    APPLY record from the log start.  A checkpoint's min-recLSN promise
    ("effects below this are on disk") holds only for the device that
    TOOK the checkpoint — a replication standby promoting over its own
    base-backup image, or a point-in-time restore over an archived log,
    must redo from the beginning (the page-LSN guard keeps it
    idempotent).  See repro.replication."""
    hdr = read_header(log_image)
    records = scan_log(log_image)
    commit_lsn, losers, aborted, intents, apply_done, ckpt = \
        analyze(records)

    rep = RecoveryReport(records=len(records),
                         winners=set(commit_lsn), losers=losers,
                         aborted=aborted,
                         truncated_lsn=hdr.truncated_lsn)
    if ckpt is not None:
        rep.checkpoint_lsn = ckpt.lsn
        _, _, dpt, snapshot = decode_checkpoint(ckpt.payload)
        rep.dpt_size = len(dpt)
        # txn-table snapshot: committed-and-applied txns whose records
        # (BEGIN through COMMIT) may have been truncated away — they
        # stay winners, and their page effects are already on disk or
        # covered by surviving APPLY records, so logical redo skips them
        rep.winners |= snapshot
        apply_done |= snapshot
        # ARIES redo bound: every APPLY below the checkpoint's min
        # recLSN had all its page effects flushed before the checkpoint
        # (a page still carrying older unflushed changes would be in
        # the DPT with a recLSN at or below that record)
        if not full_redo:
            rep.redo_start = min(dpt.values()) if dpt else ckpt.lsn

    eng = RecoveredEngine(data_image, page_size=hdr.page_size,
                          value_size=hdr.value_size, root=hdr.root,
                          next_pid=hdr.next_pid, pool_frames=pool_frames,
                          spec=spec)

    def redo():
        pool, tree = eng.pool, eng.tree
        root, next_pid = hdr.root, hdr.next_pid
        # ---- pass 2: physiological page redo, LSN order
        for r in records:
            if r.type == RecordType.CHECKPOINT:
                root, next_pid, _, _ = decode_checkpoint(r.payload)
                continue
            if r.type != RecordType.APPLY:
                continue
            rep.apply_records += 1
            root, next_pid, entries = decode_apply(r.payload)
            if r.lsn < rep.redo_start:     # effects on disk pre-ckpt;
                rep.applies_before_ckpt += 1  # root/next still tracked
                continue
            for kind, pid, data in entries:
                idx = yield from pool.fix(pid)
                page = pool.page(idx)
                if pool.page_lsn(idx) >= r.lsn and pool.page_lsn(idx) > 0:
                    rep.pages_skipped += 1
                    pool.unfix(idx)
                    continue
                if kind == APPLY_IMG:
                    page[:] = data            # image embeds its page LSN
                else:
                    key, value = decode_kv(data)
                    _redo_upsert(page, hdr.page_size, hdr.value_size,
                                 key, value)
                    set_page_lsn(page, r.lsn)
                pool.meta[idx].rec_lsn = 0    # recovery pool has no WAL
                rep.pages_redone += 1
                pool.unfix(idx, dirty=True)
        tree.root, tree.next_pid = root, next_pid
        # ---- pass 3: logical redo of winners without APPLY_END
        for txn in sorted(commit_lsn, key=commit_lsn.get):
            if txn in apply_done:
                continue
            rep.logically_replayed += 1
            for rtype, key, value in intents.get(txn, []):
                if rtype == RecordType.INSERT:
                    yield from tree.insert(key, value)  # idempotent upsert
                else:
                    yield from tree.update(key, value)  # no-op if missing

    eng.run(redo())
    return eng, rep


def _redo_upsert(page: bytearray, page_size: int, value_size: int,
                 key: int, value: bytes) -> None:
    """Re-apply one leaf upsert to a page at its exact pre-record state
    (guaranteed by the page-LSN guard)."""
    node = _Node(page, page_size, value_size)
    assert node.is_leaf, "delta redo against a non-leaf page"
    n = node.nkeys
    keys = node.keys()
    j = int(np.searchsorted(keys[:n], key))
    vals = node.values()
    if j < n and keys[j] == key:
        vals[j, :len(value)] = np.frombuffer(value, np.uint8)
        return
    assert n < node.lf, "delta redo would overflow the leaf"
    keys[j + 1:n + 1] = keys[j:n].copy()
    vals[j + 1:n + 1] = vals[j:n].copy()
    keys[j] = key
    vals[j, :len(value)] = np.frombuffer(value, np.uint8)
    node.nkeys = n + 1
