"""Crash recovery for the LSM engine: manifest rebuild + WAL replay.

Offline, pure functions over the two frozen device images (see
``LSMEngine.crash_images``) — the same shape as the B-tree engine's
``repro.wal.recovery``:

1. **Manifest rebuild.**  Scan the durable log (``scan_log`` stops at
   the torn tail) and fold every LSM_FLUSH / LSM_COMPACT record into
   the live-table set.  Each surviving table is reopened from the data
   image with its CRC footer checked (``open_from_image``); pages of a
   half-written table that never got its manifest record are simply
   never referenced (orphans).

2. **Replay horizon.**  Every LSM_FLUSH record carries the lowest
   COMMIT LSN whose effects were NOT yet fully captured in flushed
   tables at its rotation.  The newest horizon whose flush chain is
   intact bounds the replay; a CRC-failed live table invalidates its
   own horizon and every later one (conservative: replay more).

3. **Logical replay.**  Committed transactions with COMMIT LSN >= the
   horizon re-apply their intent records into an overlay map under the
   same per-key commit-LSN write rule the live memtable uses — so the
   recovered state is exactly the commit-order logical state, no
   matter where the crash fell relative to flushes and compactions.

``RecoveredLSM.get`` then reads overlay → L0 (newest flush first) →
sorted levels, straight from the image bytes (no simulation)."""

from __future__ import annotations

from bisect import bisect_right
from typing import Dict, List, Optional, Tuple

from repro_torch.lsm.sstable import (SSTable, decode_compact_payload,
                                     decode_flush_payload, open_from_image,
                                     search_page)
from repro_torch.wal.log import (BLOCK, RecordType, decode_kv, read_header,
                                 scan_log)


class RecoveredLSM:
    """Read-only recovered store: overlay (replayed WAL) over the
    reconstructed table levels."""

    def __init__(self, image: bytes, page_size: int,
                 tables: List[SSTable],
                 overlay: Dict[int, Tuple[bytes, int]],
                 horizon: int, replayed: int):
        self.image = image
        self.page_size = page_size
        self.overlay = overlay
        self.horizon = horizon
        self.replayed_txns = replayed
        max_level = max([t.level for t in tables], default=0)
        self.levels: List[List[SSTable]] = \
            [[] for _ in range(max_level + 1)]
        for t in tables:
            self.levels[t.level].append(t)
        self.levels[0].sort(key=lambda t: -t.seq)       # newest first
        for lv in self.levels[1:]:
            lv.sort(key=lambda t: t.min_key)

    def n_tables(self) -> int:
        return sum(len(lv) for lv in self.levels)

    def _page(self, pid: int) -> bytes:
        ps = self.page_size
        return self.image[pid * ps:(pid + 1) * ps]

    def _search(self, t: SSTable, key: int) -> Optional[bytes]:
        return search_page(self._page(t.page_pid_for(key)), key)

    def get(self, key: int) -> Optional[bytes]:
        hit = self.overlay.get(key)
        if hit is not None:
            return hit[0]
        for t in self.levels[0]:
            if t.min_key <= key <= t.max_key and t.may_contain(key):
                v = self._search(t, key)
                if v is not None:
                    return v
        for lv in self.levels[1:]:
            if not lv:
                continue
            i = bisect_right([t.min_key for t in lv], key) - 1
            if i < 0 or key > lv[i].max_key:
                continue
            if not lv[i].may_contain(key):
                continue
            v = self._search(lv[i], key)
            if v is not None:
                return v
        return None


def recover_lsm(log_image: bytes, data_image: bytes) -> RecoveredLSM:
    header = read_header(log_image)
    ps = header.page_size
    records = scan_log(log_image)

    # -- 1. fold manifest deltas into the live ref set ------------------
    live: Dict[int, Tuple] = {}          # id -> (id,seq,level,pid,n_pages)
    flush_chain: List[Tuple[int, int]] = []     # (horizon, table_id)
    for rec in records:
        if rec.type == RecordType.LSM_FLUSH:
            horizon, ref = decode_flush_payload(rec.payload)
            live[ref[0]] = ref
            flush_chain.append((horizon, ref[0]))
        elif rec.type == RecordType.LSM_COMPACT:
            removed, added = decode_compact_payload(rec.payload)
            for tid in removed:
                live.pop(tid, None)
            for ref in added:
                live[ref[0]] = ref

    tables: List[SSTable] = []
    failed = set()
    for tid, (t_id, seq, level, base_pid, n_pages) in live.items():
        t = open_from_image(data_image, base_pid, n_pages, ps)
        # a CRC-failed or geometry-mismatched table is treated as
        # nonexistent; its data comes back through a wider replay
        if t is None or t.id != t_id:
            failed.add(tid)
        else:
            tables.append(t)

    # -- 2. the replay horizon -----------------------------------------
    # horizons are monotone in record order (flushes are serialized);
    # adopt them in order and stop at the first broken flush
    horizon = BLOCK
    for h, tid in flush_chain:
        if tid in failed:
            break
        horizon = max(horizon, h)

    # -- 3. logical replay of committed txns ---------------------------
    writes: Dict[int, List[Tuple[int, bytes]]] = {}
    overlay: Dict[int, Tuple[bytes, int]] = {}
    replayed = 0
    for rec in records:
        if rec.type in (RecordType.UPDATE, RecordType.INSERT):
            writes.setdefault(rec.txn, []).append(decode_kv(rec.payload))
        elif rec.type == RecordType.ABORT:
            writes.pop(rec.txn, None)
        elif rec.type == RecordType.COMMIT:
            clsn = rec.lsn
            ws = writes.pop(rec.txn, None)
            if clsn < horizon or not ws:
                continue
            replayed += 1
            for key, value in ws:
                cur = overlay.get(key)
                if cur is None or cur[1] <= clsn:
                    overlay[key] = (value, clsn)
    # txns still in ``writes`` never committed: losers, dropped

    return RecoveredLSM(data_image, ps, tables, overlay, horizon,
                        replayed)
