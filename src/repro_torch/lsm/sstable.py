"""Immutable, CRC-footed SSTables on the simulated NVMe device.

On-device layout (page-aligned, ``n_pages`` contiguous pages starting
at ``base_pid``)::

    data pages   u16 n_entries, then n x (<qH> key, vlen + value),
                 entries sorted by key and never spanning pages
    meta pages   one serialized blob split across pages:
                 <II> bloom_nbytes, n_fences; bloom bits; n_fences x <q>
                 (fence i = first key of data page i)
    footer page  <8sQQIIIIqq> magic, table_id, seq, level, n_data,
                 n_meta, n_entries, min_key, max_key + <I> crc32 over
                 every data+meta page byte

The footer CRC is the torn-table detector: recovery recomputes it
before trusting a table (``open_from_image``), so a crash mid-write
leaves either an orphaned page range (no manifest record — ignored) or
a CRC-rejected table (manifest record without a durable table — also
ignored; the WAL replays its data instead).

The in-memory ``SSTable`` handle keeps the read-path metadata resident
(bloom filter, fence pointers, key range), as real LSM engines do; only
data pages are fetched through the ``BufferPool``/ring on lookups.

``TableIO`` is the write path: batched write submissions through the
ring (registered staging slots when available, ``+Passthru`` when the
device supports it), with the WAL's transient-error recovery policy —
failed or short chunk writes are re-issued with capped exponential
backoff, and the table is only installed after a durability barrier.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Generator, List, Optional, Tuple

from repro_torch.core.fibers import IoRequest
from repro_torch.core.ring import (prep_fsync, prep_timeout, prep_write,
                                   prep_write_fixed)
from repro_torch.wal.log import WriteAheadLog

_MAGIC = b"SSTABLE1"
_FOOTER = struct.Struct("<8sQQIIIIqq")      # magic, id, seq, level,
                                            # n_data, n_meta, n_entries,
                                            # min_key, max_key
_CRC = struct.Struct("<I")
_ENTRY = struct.Struct("<qH")               # key, vlen
_META_HDR = struct.Struct("<II")            # bloom_nbytes, n_fences
_TABLE_META = struct.Struct("<QQIQI")       # id, seq, level, base_pid,
                                            # n_pages (manifest records)

BLOOM_HASHES = 4


def _bloom_slots(key: int, m_bits: int) -> List[int]:
    b = struct.pack("<q", key)
    h1 = zlib.crc32(b)
    h2 = zlib.crc32(b, 0x9747B28C) | 1
    return [(h1 + i * h2) % m_bits for i in range(BLOOM_HASHES)]


class SSTable:
    """Resident read-path handle of one on-device table."""

    __slots__ = ("id", "seq", "level", "base_pid", "n_data", "n_meta",
                 "n_entries", "min_key", "max_key", "fences", "bloom",
                 "bloom_bits")

    def __init__(self, id: int, seq: int, level: int, base_pid: int,
                 n_data: int, n_meta: int, n_entries: int, min_key: int,
                 max_key: int, fences: List[int], bloom: bytes):
        self.id = id
        self.seq = seq              # flush sequence (L0 recency order)
        self.level = level
        self.base_pid = base_pid
        self.n_data = n_data
        self.n_meta = n_meta
        self.n_entries = n_entries
        self.min_key = min_key
        self.max_key = max_key
        self.fences = fences        # first key of each data page
        self.bloom = bloom
        self.bloom_bits = len(bloom) * 8

    @property
    def n_pages(self) -> int:
        return self.n_data + self.n_meta + 1

    def data_bytes(self, page_size: int) -> int:
        return self.n_data * page_size

    def may_contain(self, key: int) -> bool:
        if key < self.min_key or key > self.max_key:
            return False
        if not self.bloom_bits:
            return True
        for slot in _bloom_slots(key, self.bloom_bits):
            if not (self.bloom[slot >> 3] >> (slot & 7)) & 1:
                return False
        return True

    def page_pid_for(self, key: int) -> int:
        """pid of the one data page whose fence range covers ``key``
        (caller has already range/bloom-checked)."""
        import bisect
        i = bisect.bisect_right(self.fences, key) - 1
        return self.base_pid + max(0, i)

    def meta_blob(self) -> bytes:
        out = [_META_HDR.pack(len(self.bloom), len(self.fences)),
               self.bloom]
        out.append(struct.pack(f"<{len(self.fences)}q", *self.fences))
        return b"".join(out)


# ---------------------------------------------------------------------------
# building / parsing
# ---------------------------------------------------------------------------

def build_table_pages(entries: List[Tuple[int, bytes]], *,
                      page_size: int, table_id: int, seq: int,
                      level: int, bloom_bits_per_key: int = 10
                      ) -> Tuple[List[bytes], SSTable]:
    """Serialize sorted ``(key, value)`` entries into the page layout.
    Returns (pages, handle); the caller assigns ``base_pid`` before
    writing/installing."""
    assert entries, "empty SSTable"
    data_pages: List[bytes] = []
    fences: List[int] = []
    cur = bytearray(2)                       # u16 n_entries placeholder
    cur_n = 0
    for key, value in entries:
        rec = _ENTRY.pack(key, len(value)) + value
        if len(cur) + len(rec) > page_size:
            struct.pack_into("<H", cur, 0, cur_n)
            data_pages.append(bytes(cur) + bytes(page_size - len(cur)))
            cur = bytearray(2)
            cur_n = 0
        if cur_n == 0:
            fences.append(key)
        cur += rec
        cur_n += 1
    struct.pack_into("<H", cur, 0, cur_n)
    data_pages.append(bytes(cur) + bytes(page_size - len(cur)))

    m_bits = max(64, bloom_bits_per_key * len(entries))
    m_bits = (m_bits + 7) & ~7
    bloom = bytearray(m_bits // 8)
    for key, _ in entries:
        for slot in _bloom_slots(key, m_bits):
            bloom[slot >> 3] |= 1 << (slot & 7)

    table = SSTable(table_id, seq, level, -1, len(data_pages), 0,
                    len(entries), entries[0][0], entries[-1][0],
                    fences, bytes(bloom))
    blob = table.meta_blob()
    meta_pages = [blob[o:o + page_size].ljust(page_size, b"\x00")
                  for o in range(0, len(blob), page_size)]
    table.n_meta = len(meta_pages)

    body = data_pages + meta_pages
    crc = 0
    for p in body:
        crc = zlib.crc32(p, crc)
    footer = _FOOTER.pack(_MAGIC, table_id, seq, level, table.n_data,
                          table.n_meta, table.n_entries, table.min_key,
                          table.max_key) + _CRC.pack(crc)
    pages = body + [footer.ljust(page_size, b"\x00")]
    return pages, table


def decode_data_page(page: bytes) -> List[Tuple[int, bytes]]:
    (n,) = struct.unpack_from("<H", page, 0)
    off = 2
    out = []
    for _ in range(n):
        key, vlen = _ENTRY.unpack_from(page, off)
        off += _ENTRY.size
        out.append((key, bytes(page[off:off + vlen])))
        off += vlen
    return out


def search_page(page: bytes, key: int) -> Optional[bytes]:
    (n,) = struct.unpack_from("<H", page, 0)
    off = 2
    for _ in range(n):
        k, vlen = _ENTRY.unpack_from(page, off)
        off += _ENTRY.size
        if k == key:
            return bytes(page[off:off + vlen])
        if k > key:
            return None
        off += vlen
    return None


def open_from_image(image, base_pid: int, n_pages: int,
                    page_size: int) -> Optional[SSTable]:
    """Reopen a table from a raw device image, validating the CRC
    footer.  Returns None for a torn/half-written table (bad magic,
    inconsistent geometry, or CRC mismatch) — recovery treats that as
    'this table does not exist'."""
    lo = base_pid * page_size
    hi = lo + n_pages * page_size
    if hi > len(image) or n_pages < 2:
        return None
    footer = bytes(image[hi - page_size:hi])
    try:
        magic, tid, seq, level, n_data, n_meta, n_entries, kmin, kmax = \
            _FOOTER.unpack_from(footer, 0)
        (crc,) = _CRC.unpack_from(footer, _FOOTER.size)
    except struct.error:
        return None
    if magic != _MAGIC or n_data + n_meta + 1 != n_pages:
        return None
    body = bytes(image[lo:hi - page_size])
    if zlib.crc32(body) != crc:
        return None
    blob = body[n_data * page_size:]
    bloom_nbytes, n_fences = _META_HDR.unpack_from(blob, 0)
    off = _META_HDR.size
    bloom = blob[off:off + bloom_nbytes]
    off += bloom_nbytes
    fences = list(struct.unpack_from(f"<{n_fences}q", blob, off))
    return SSTable(tid, seq, level, base_pid, n_data, n_meta, n_entries,
                   kmin, kmax, fences, bloom)


# ---------------------------------------------------------------------------
# manifest record payloads (LSM_FLUSH / LSM_COMPACT, repro.wal.log)
# ---------------------------------------------------------------------------

def encode_table_ref(t: SSTable) -> bytes:
    return _TABLE_META.pack(t.id, t.seq, t.level, t.base_pid, t.n_pages)


def decode_table_refs(payload: bytes, off: int, n: int):
    """n (id, seq, level, base_pid, n_pages) tuples; returns (refs,
    next offset)."""
    refs = []
    for _ in range(n):
        refs.append(_TABLE_META.unpack_from(payload, off))
        off += _TABLE_META.size
    return refs, off


def encode_flush_payload(horizon: int, t: SSTable) -> bytes:
    return struct.pack("<Q", horizon) + encode_table_ref(t)


def decode_flush_payload(payload: bytes):
    (horizon,) = struct.unpack_from("<Q", payload)
    refs, _ = decode_table_refs(payload, 8, 1)
    return horizon, refs[0]


def encode_compact_payload(removed_ids: List[int],
                           added: List[SSTable]) -> bytes:
    out = [struct.pack("<II", len(removed_ids), len(added))]
    out.append(struct.pack(f"<{len(removed_ids)}Q", *removed_ids))
    out.extend(encode_table_ref(t) for t in added)
    return b"".join(out)


def decode_compact_payload(payload: bytes):
    n_rm, n_add = struct.unpack_from("<II", payload)
    off = 8
    removed = list(struct.unpack_from(f"<{n_rm}Q", payload, off))
    off += 8 * n_rm
    added, _ = decode_table_refs(payload, off, n_add)
    return removed, added


# ---------------------------------------------------------------------------
# the ring write path
# ---------------------------------------------------------------------------

class TableIO:
    """Batched SSTable page writes + durability barrier on the ring.

    One ``write_table`` call stages the table's pages into chunks of up
    to ``STAGING_BLOCKS`` pages, submits every chunk in ONE batched
    submission (registered staging slots for the first ``N_STAGING``
    chunks — one pass per batch, like the WAL — plain copied writes for
    the overflow), then issues the barrier (NVMe flush under
    ``+Passthru``, worker-path fsync otherwise).

    Error recovery is the WAL's policy verbatim (same constants): an
    errored or short chunk is re-written after capped exponential
    backoff; the budget exhausting is a fail-stop.  Chunk re-writes are
    idempotent — the table is not installed until the barrier of a
    fully-clean attempt."""

    MAX_RETRIES = WriteAheadLog.MAX_RETRIES
    BACKOFF_BASE = WriteAheadLog.BACKOFF_BASE
    BACKOFF_CAP = WriteAheadLog.BACKOFF_CAP
    N_STAGING = 8
    STAGING_BLOCKS = 8                 # pages per chunk (32 KiB)

    def __init__(self, ring, fd: int, page_size: int, *,
                 buf_base: Optional[int] = None, passthru: bool = False):
        self.ring = ring
        self.fd = fd
        self.page_size = page_size
        self.passthru = passthru
        self.buf_base = buf_base       # registered slot of staging[0]
        self.staging = [bytearray(page_size * self.STAGING_BLOCKS)
                        for _ in range(self.N_STAGING)]
        self.write_retries = 0
        self.write_errors = 0
        self.chunks_written = 0
        self.bytes_written = 0

    def _chunk_req(self, slot: Optional[int], offset: int, data: bytes,
                   ci: int, req_len: Dict[int, Tuple[int, int]]
                   ) -> IoRequest:
        if slot is not None:
            self.staging[slot][:len(data)] = data

            def prep(sqe, ud, slot=slot, offset=offset, n=len(data),
                     ci=ci):
                prep_write_fixed(sqe, self.fd, self.buf_base + slot,
                                 offset, n)
                if self.passthru:
                    sqe.cmd = "passthru"
                req_len[ud] = (ci, n)
            return IoRequest(prep)

        def prep(sqe, ud, data=data, offset=offset, ci=ci):
            prep_write(sqe, self.fd, memoryview(data), offset, len(data))
            if self.passthru:
                sqe.cmd = "passthru"
            req_len[ud] = (ci, len(data))
        return IoRequest(prep)

    def _barrier_req(self) -> IoRequest:
        def prep(sqe, ud):
            prep_fsync(sqe, self.fd, nvme_flush=self.passthru)
        return IoRequest(prep)

    def _sleep_req(self, seconds: float) -> IoRequest:
        def prep(sqe, ud):
            prep_timeout(sqe, seconds)
        return IoRequest(prep)

    def write_table(self, base_pid: int, pages: List[bytes]) -> Generator:
        """Fiber generator: write ``pages`` at ``base_pid`` and make
        them durable.  Returns the number of write attempts issued."""
        ps = self.page_size
        cap = ps * self.STAGING_BLOCKS
        blob = b"".join(pages)
        chunks = [(base_pid * ps + o, blob[o:o + cap])
                  for o in range(0, len(blob), cap)]
        pending = list(range(len(chunks)))
        attempts = 0
        # per-call request map: one TableIO instance serves exactly one
        # in-flight write_table (flusher and compactor each own one),
        # but the map still must not leak across retry attempts
        req_len: Dict[int, Tuple[int, int]] = {}
        for attempt in range(self.MAX_RETRIES + 1):
            req_len.clear()
            reqs = []
            for i, ci in enumerate(pending):
                off, data = chunks[ci]
                slot = i if (i < self.N_STAGING
                             and self.buf_base is not None
                             and self.ring.bufs is not None) else None
                reqs.append(self._chunk_req(slot, off, data, ci, req_len))
            attempts += len(reqs)
            self.chunks_written += len(reqs)
            cqes = yield reqs
            bad = [c for c in cqes
                   if c.res < 0 or c.res < req_len[c.user_data][1]]
            if not bad:
                # barrier before the manifest record references the
                # table.  A failed barrier means the page cache may have
                # DROPPED the dirty span (fsyncgate — see SimDisk), so
                # the recovery is a full re-write + re-barrier, exactly
                # like the WAL's flush retry.
                barrier = yield self._barrier_req()
                if barrier.res >= 0:
                    break
                bad = [barrier]
                pending = list(range(len(chunks)))
            else:
                # WAL backoff policy: re-write only the failed chunks
                pending = sorted(req_len[c.user_data][0] for c in bad)
            self.write_errors += len(bad)
            if attempt >= self.MAX_RETRIES:
                raise RuntimeError(
                    f"sstable write failed after {attempt + 1} attempts "
                    f"(res={[c.res for c in bad]})")
            self.write_retries += 1
            yield self._sleep_req(
                min(self.BACKOFF_CAP, self.BACKOFF_BASE * (2 ** attempt)))
        else:
            raise RuntimeError("sstable write failed: retries exhausted")
        self.bytes_written += len(blob)
        return attempts
