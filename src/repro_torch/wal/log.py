"""Append-only write-ahead log over a dedicated ``SimDisk`` fd.

Record framing (little-endian)::

    [0:4]   u32  crc32 of bytes [4:size)
    [4:8]   u32  size (total record bytes, incl. this header)
    [8]     u8   RecordType
    [9:17]  u64  txn id
    [17:]        payload

The LSN of a record is its byte offset in the log; ``end_lsn`` is the
offset one past the last appended byte, so "durable up to L" means every
record starting below L is fsynced.  Offsets [0:4096) hold a header
block (magic + engine geometry) written at bootstrap, so recovery is
self-describing and page LSN 0 (bulk-loaded pages) sorts before every
record.

Appends go into an in-memory tail; ``flush_to`` writes the 4 KiB-aligned
span covering [durable_lsn, target) — re-writing the partial last block,
as real WALs do — and then makes it durable on one of the paper's three
Fig. 9 paths (see ``mode``).  With registered buffers available the
write is staged through pinned 4 KiB-aligned slots (``WRITE_FIXED``, no
bounce copy); otherwise a plain write is used.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.fibers import IoRequest
from repro_torch.core.ring import (prep_fsync, prep_timeout, prep_write,
                                   prep_write_fixed)
from repro_torch.core.sqe import CqeFlags, ENOTSUP, ETIME, SqeFlags


class WalFailStop(RuntimeError):
    """Persistent log-device failure: the retry budget is exhausted and
    the WAL refuses to ack any further commits.  The engine must treat
    this as a crash and go through recovery — continuing would ack
    commits whose durability is unknown (the fsyncgate failure mode)."""

BLOCK = 4096
_REC_HDR = struct.Struct("<IIBQ")            # crc, size, type, txn
_HDR_MAGIC = b"WALHDR2\x00"
_LOG_HDR = struct.Struct("<8sQQQQQQ")        # magic, root, next_pid,
                                             # page_size, value_size,
                                             # data_capacity,
                                             # truncated_lsn


class RecordType:
    BEGIN = 1        # first write of a txn
    UPDATE = 2       # logical intent: key/value upsert of an existing key
    INSERT = 3       # logical intent: key/value insert
    COMMIT = 4       # txn is durable once this record is
    ABORT = 5        # txn discarded; recovery ignores it
    APPLY = 6        # one applied tree op: page deltas / images + meta
    APPLY_END = 7    # all of the txn's APPLY records are in the log
    CHECKPOINT = 8   # fuzzy checkpoint: root/next_pid + dirty-page table
    LSM_FLUSH = 9    # LSM manifest delta: one memtable flushed to L0
    LSM_COMPACT = 10  # LSM manifest delta: tables merged to level+1

    _NAMES = {1: "BEGIN", 2: "UPDATE", 3: "INSERT", 4: "COMMIT",
              5: "ABORT", 6: "APPLY", 7: "APPLY_END", 8: "CHECKPOINT",
              9: "LSM_FLUSH", 10: "LSM_COMPACT"}

    @classmethod
    def name(cls, t: int) -> str:
        return cls._NAMES.get(t, f"?{t}")


@dataclass
class LogRecord:
    lsn: int
    type: int
    txn: int
    payload: bytes

    @property
    def end(self) -> int:
        return self.lsn + _REC_HDR.size + len(self.payload)


@dataclass
class WalStats:
    """WAL-side counters; combine with ``RingStats`` (shared ring) for
    the full per-path cycle attribution."""

    records: int = 0
    bytes_appended: int = 0
    flushes: int = 0
    fsyncs: int = 0
    write_sqes: int = 0
    blocks_written: int = 0
    unstaged_writes: int = 0          # flush spans that missed the
                                      # registered staging slots
    commits: int = 0
    commit_wait_s: float = 0.0        # sum of commit->durable latency
    fsync_worker: int = 0             # fsync CQEs per execution path
    fsync_polled: int = 0             # (paper Fig. 3 attribution)
    fsync_inline: int = 0
    truncations: int = 0              # checkpoint-driven log truncations
    bytes_reclaimed: int = 0          # log space zeroed by truncation
    io_retries: int = 0               # flush attempts redone after an
                                      # error/short CQE (capped backoff)
    flush_errors: int = 0             # error/short CQEs seen by flushes
    passthru_degrades: int = 0        # passthru -> linked fallbacks
                                      # (ENOTSUP / cmd timeout)
    failstops: int = 0                # retry budget exhausted
    groups: List[int] = field(default_factory=list)

    def mean_group(self) -> float:
        return sum(self.groups) / len(self.groups) if self.groups else 0.0

    def mean_commit_wait_s(self) -> float:
        return self.commit_wait_s / self.commits if self.commits else 0.0


# ---------------------------------------------------------------------------
# record encoding
# ---------------------------------------------------------------------------

def encode_record(rtype: int, txn: int, payload: bytes = b"") -> bytes:
    size = _REC_HDR.size + len(payload)
    body = _REC_HDR.pack(0, size, rtype, txn)[4:] + payload
    return struct.pack("<I", zlib.crc32(body)) + body


def encode_kv(rtype: int, txn: int, key: int, value: bytes) -> bytes:
    return encode_record(rtype, txn,
                         struct.pack("<qH", key, len(value)) + value)


def decode_kv(payload: bytes) -> Tuple[int, bytes]:
    key, vlen = struct.unpack_from("<qH", payload)
    return key, payload[10:10 + vlen]


# APPLY payload: root, next_pid, n_entries, then per entry:
#   u8 kind (0 = leaf-upsert delta, 1 = full page image)
#   u64 pid, u16 nbytes, payload (delta: <qH>key,vlen + value; img: page)
APPLY_DELTA = 0
APPLY_IMG = 1


def encode_apply(txn: int, root: int, next_pid: int,
                 entries: List[Tuple[int, int, bytes]]) -> bytes:
    out = [struct.pack("<QQH", root, next_pid, len(entries))]
    for kind, pid, data in entries:
        out.append(struct.pack("<BQH", kind, pid, len(data)))
        out.append(data)
    return encode_record(RecordType.APPLY, txn, b"".join(out))


def decode_apply(payload: bytes):
    root, next_pid, n = struct.unpack_from("<QQH", payload)
    off = 18
    entries = []
    for _ in range(n):
        kind, pid, nbytes = struct.unpack_from("<BQH", payload, off)
        off += 11
        entries.append((kind, pid, payload[off:off + nbytes]))
        off += nbytes
    return root, next_pid, entries


def _id_ranges(ids) -> List[Tuple[int, int]]:
    """Compress a set of ints to sorted (start, count) runs — txn ids
    are near-contiguous, so the txn-table snapshot stays tiny."""
    out: List[Tuple[int, int]] = []
    for t in sorted(ids):
        if out and t == out[-1][0] + out[-1][1]:
            out[-1] = (out[-1][0], out[-1][1] + 1)
        else:
            out.append((t, 1))
    return out


def encode_checkpoint(root: int, next_pid: int, dpt: Dict[int, int],
                      committed=()) -> bytes:
    """``committed``: the txn-table snapshot — ids of txns that are
    durable-committed AND fully applied at checkpoint time.  Their
    BEGIN/intent/COMMIT records may fall below a later truncation
    horizon; the snapshot keeps them in recovery's winner set."""
    out = [struct.pack("<QQH", root, next_pid, len(dpt))]
    for pid, rec_lsn in sorted(dpt.items()):
        out.append(struct.pack("<QQ", pid, rec_lsn))
    ranges = _id_ranges(committed)
    out.append(struct.pack("<I", len(ranges)))
    for start, count in ranges:
        out.append(struct.pack("<QI", start, count))
    return encode_record(RecordType.CHECKPOINT, 0, b"".join(out))


def decode_checkpoint(payload: bytes):
    """Returns (root, next_pid, dpt, committed-txn snapshot)."""
    root, next_pid, n = struct.unpack_from("<QQH", payload)
    dpt = {}
    for i in range(n):
        pid, rec_lsn = struct.unpack_from("<QQ", payload, 18 + 16 * i)
        dpt[pid] = rec_lsn
    off = 18 + 16 * n
    committed: set = set()
    if off + 4 <= len(payload):          # pre-snapshot records: empty
        (n_ranges,) = struct.unpack_from("<I", payload, off)
        off += 4
        for _ in range(n_ranges):
            start, count = struct.unpack_from("<QI", payload, off)
            off += 12
            committed.update(range(start, start + count))
    return root, next_pid, dpt, committed


@dataclass
class LogHeader:
    root: int
    next_pid: int
    page_size: int
    value_size: int
    data_capacity: int
    truncated_lsn: int = 0     # log space below this LSN was reclaimed


def encode_header(hdr: LogHeader) -> bytes:
    raw = _LOG_HDR.pack(_HDR_MAGIC, hdr.root, hdr.next_pid, hdr.page_size,
                        hdr.value_size, hdr.data_capacity,
                        hdr.truncated_lsn)
    return raw + bytes(BLOCK - len(raw))


def read_header(log_image: bytes) -> LogHeader:
    magic, root, next_pid, ps, vs, cap, trunc = \
        _LOG_HDR.unpack_from(log_image, 0)
    if magic != _HDR_MAGIC:
        raise ValueError("not a WAL image (bad magic)")
    return LogHeader(root, next_pid, ps, vs, cap, trunc)


def scan_log(log_image: bytes) -> List[LogRecord]:
    """Decode every complete, CRC-valid record; stop at the first torn
    or zeroed frame (the crash point).  Starts at the header's
    ``truncated_lsn`` — reclaimed space below it is zeroed and must not
    be mistaken for the crash point."""
    out: List[LogRecord] = []
    off = BLOCK
    try:
        off = max(off, read_header(log_image).truncated_lsn)
    except (ValueError, struct.error):
        pass                   # headerless/corrupt image: raw scan
    n = len(log_image)
    while off + _REC_HDR.size <= n:
        crc, size, rtype, txn = _REC_HDR.unpack_from(log_image, off)
        if size < _REC_HDR.size or off + size > n:
            break
        if zlib.crc32(log_image[off + 4:off + size]) != crc:
            break
        if rtype not in RecordType._NAMES:
            break
        out.append(LogRecord(off, rtype,
                             txn, bytes(log_image[off + 17:off + size])))
        off += size
    return out


# ---------------------------------------------------------------------------
# the log itself
# ---------------------------------------------------------------------------

class WriteAheadLog:
    """Append + flush state machine shared by all fibers of one engine.

    ``mode`` picks the durability path (paper Fig. 9):
      ``fsync``     write (one submission), then fsync (second
                    submission) — the fsync blocks in the filesystem and
                    takes the io_worker fallback
      ``linked``    write→fsync as one IO_LINK'd chain, one submission
      ``passthru``  passthrough write + NVMe flush command; on a PLP
                    device the flush completes async in ~5 µs
    """

    N_STAGING = 8                      # registered staging slots
    STAGING_BLOCKS = 8                 # blocks per slot (32 KiB)

    def __init__(self, ring, fd: int, disk, *, mode: str = "linked",
                 buf_base: Optional[int] = None,
                 header: Optional[LogHeader] = None):
        assert mode in ("fsync", "linked", "passthru")
        if mode == "passthru" and not disk.supports_passthrough():
            raise ValueError("passthru flush needs a filesystem-less "
                             "(O_DIRECT block / passthrough) log device")
        self.ring = ring
        self.fd = fd
        self.disk = disk
        self.mode = mode
        self.buf_base = buf_base       # registered-buffer slot of staging[0]
        self.staging = [bytearray(BLOCK * self.STAGING_BLOCKS)
                        for _ in range(self.N_STAGING)]
        self._next_slot = 0
        self.header = header or LogHeader(0, 0, BLOCK, 0, 0)
        # bootstrap: header block goes straight into the device image,
        # exactly like bulk_load seeds the data disk
        self.buf = bytearray(encode_header(self.header))
        disk.image[:BLOCK] = self.buf
        self.durable_lsn = BLOCK
        self.flushed_lsn = BLOCK
        self.truncated_lsn = BLOCK
        self._flushing = False
        self.stats = WalStats()
        # expected byte count per in-flight write ud — CQEs come back
        # in arrival order, so short writes are detected by matching
        # user_data against the length recorded at prep time
        self._req_len: Dict[int, int] = {}
        # flush hooks: called as cb(prev_durable, new_durable) after
        # every flush that advances the durable horizon — the log-
        # shipping sender taps these spans (repro.replication)
        self.on_flush: List[Callable[[int, int], None]] = []

    # ------------------------------------------------------------ append

    @property
    def end_lsn(self) -> int:
        return len(self.buf)

    def append(self, record: bytes) -> int:
        """Buffer one encoded record; returns its LSN (start offset).
        Purely in-memory — durability comes from ``flush_to``."""
        lsn = len(self.buf)
        self.buf += record
        self.stats.records += 1
        self.stats.bytes_appended += len(record)
        return lsn

    def append_raw(self, span: bytes, lsn: int) -> None:
        """Adopt a shipped byte span of ANOTHER log (replication standby:
        the primary's flushed records land here verbatim, so the two
        logs stay byte-identical and LSNs line up).  ``lsn`` must be
        this log's current ``end_lsn`` — spans arrive in order on one
        stream; a gap means the shipping protocol broke."""
        assert lsn == self.end_lsn, \
            f"non-contiguous shipped span: have {self.end_lsn}, got {lsn}"
        self.buf += span
        self.stats.bytes_appended += len(span)

    def adopt_header(self, hdr_block: bytes) -> None:
        """Install a shipped bootstrap header block (replication HELLO):
        overwrites this log's block 0 in buffer and on device so the
        standby's image is self-describing with the PRIMARY's geometry."""
        assert len(hdr_block) == BLOCK
        self.header = read_header(hdr_block)
        self.buf[:BLOCK] = hdr_block
        self.disk.image[:BLOCK] = hdr_block

    # ------------------------------------------------------------- flush

    def flush_to(self, target: int, mode: Optional[str] = None):
        """Fiber generator: suspend until ``durable_lsn >= target``.
        One flusher at a time; concurrent callers wait cooperatively
        (the group-commit coordinator builds its batching on this)."""
        mode = mode or self.mode
        while self.durable_lsn < target:
            if self._flushing:
                yield None             # someone else's flush is in flight
                continue
            self._flushing = True
            try:
                yield from self._flush_once(mode)
            finally:
                self._flushing = False

    def flush_solo(self, mode: Optional[str] = None):
        """Naive per-txn durability (the ``+WAL`` rung): the committer
        ALWAYS pays its own write+fsync for its records, even if a
        concurrent flush already covered them — exactly the redundant
        barrier traffic group commit exists to amortize."""
        mode = mode or self.mode
        while self._flushing:
            yield None
        self._flushing = True
        try:
            yield from self._flush_once(mode)
        finally:
            self._flushing = False

    #: transient-error recovery policy: full span re-write + re-fsync
    #: per attempt, exponential backoff capped at BACKOFF_CAP, then
    #: fail-stop (WalFailStop).  The span re-WRITE before the re-fsync
    #: is what makes the retry fsyncgate-correct — a failed fsync means
    #: the page cache may have DROPPED the dirty span, so retrying just
    #: the fsync would durably persist nothing (see SimDisk).
    MAX_RETRIES = 8
    BACKOFF_BASE = 100e-6
    BACKOFF_CAP = 10e-3

    def _sleep_req(self, seconds: float) -> IoRequest:
        def prep(sqe, ud):
            prep_timeout(sqe, seconds)
        return IoRequest(prep)

    def _flush_once(self, mode: str):
        """Write the aligned span [durable_lsn, end_lsn) + barrier.
        Flushes EVERYTHING appended so far — records that piled up while
        a previous flush was in flight ride along for free (this is what
        group commit amortizes).

        ``durable_lsn`` advances ONLY when every write and the fsync of
        one attempt succeeded in full, so group commit can never ack a
        commit whose barrier failed."""
        self.stats.flushes += 1
        target = self.end_lsn
        for attempt in range(self.MAX_RETRIES + 1):
            if mode == "passthru" and self.mode != "passthru":
                mode = self.mode           # degraded under this flush
            lo = (self.durable_lsn // BLOCK) * BLOCK
            hi = ((target + BLOCK - 1) // BLOCK) * BLOCK
            span = bytes(self.buf[lo:hi])
            span += bytes(hi - lo - len(span))      # zero-pad the tail
            self._req_len.clear()
            reqs = self._write_reqs(lo, span, mode)
            if mode == "fsync":
                # NB: yielding an empty list would strand the fiber (the
                # scheduler has nothing to wake it with); span can be
                # empty in flush_solo when everything is already durable,
                # but the naive engine still pays its fsync
                cqes = list((yield reqs)) if reqs else []  # submission 1
                fsync_cqe = yield self._fsync_req(mode)    # submission 2
                cqes = cqes + [fsync_cqe]
            else:
                # one linked chain: writes IO_LINK'd, fsync terminates
                reqs.append(self._fsync_req(mode))
                cqes = yield reqs
            bad = [c for c in cqes
                   if c.res < 0 or c.res < self._req_len.get(
                       c.user_data, 0)]
            if not bad:
                f = cqes[-1].flags      # the fsync completes last
                if f & CqeFlags.WORKER:
                    self.stats.fsync_worker += 1
                elif f & CqeFlags.INLINE:
                    self.stats.fsync_inline += 1
                else:
                    self.stats.fsync_polled += 1
                break
            self.stats.flush_errors += len(bad)
            if mode == "passthru" and any(
                    c.res in (ENOTSUP, ETIME) for c in bad):
                # the device rejected / timed out the uring-cmd path:
                # degrade this WAL to the linked write->fsync path for
                # good (counted; advisor-visible via the ring stats)
                self.stats.passthru_degrades += 1
                self.ring.stats.passthru_fallbacks += 1
                self.mode = mode = "linked"
                continue               # retry immediately on the new path
            if attempt >= self.MAX_RETRIES:
                self.stats.failstops += 1
                raise WalFailStop(
                    f"log I/O failed after {attempt + 1} attempts: "
                    f"res={[c.res for c in bad]}")
            self.stats.io_retries += 1
            yield self._sleep_req(
                min(self.BACKOFF_CAP, self.BACKOFF_BASE * (2 ** attempt)))
        else:
            self.stats.failstops += 1
            raise WalFailStop(f"log I/O failed after "
                              f"{self.MAX_RETRIES + 1} attempts")
        self.flushed_lsn = max(self.flushed_lsn, target)
        prev = self.durable_lsn
        self.durable_lsn = max(self.durable_lsn, target)
        if self.durable_lsn > prev:
            for cb in self.on_flush:
                cb(prev, self.durable_lsn)

    def _write_reqs(self, lo: int, span: bytes, mode: str):
        reqs = []
        cap = BLOCK * self.STAGING_BLOCKS
        off = 0
        n_fixed = 0
        while off < len(span):
            chunk = span[off:off + cap]
            # at most one pass over the staging slots per flush: the
            # simulated device reads the slot at ISSUE time (linked
            # chains issue sequentially), so reusing a slot within one
            # flush would overwrite data before it is written — the
            # overflow falls back to plain (copied) writes instead
            fixed = n_fixed < self.N_STAGING
            reqs.append(self._one_write(lo + off, chunk, mode, fixed))
            n_fixed += 1
            off += len(chunk)
        self.stats.write_sqes += len(reqs)
        self.stats.blocks_written += len(span) // BLOCK
        return reqs

    def _one_write(self, offset: int, chunk: bytes, mode: str,
                   fixed: bool) -> IoRequest:
        fixed = (fixed and self.buf_base is not None and
                 self.ring.bufs is not None)
        link = SqeFlags.IO_LINK if mode != "fsync" else SqeFlags.NONE
        if fixed:
            slot = self._next_slot
            self._next_slot = (slot + 1) % self.N_STAGING
            self.staging[slot][:len(chunk)] = chunk

            def prep(sqe, ud, slot=slot, offset=offset, n=len(chunk)):
                prep_write_fixed(sqe, self.fd, self.buf_base + slot,
                                 offset, n, flags=link)
                if mode == "passthru":
                    sqe.cmd = "passthru"
                self._req_len[ud] = n
            return IoRequest(prep)
        self.stats.unstaged_writes += 1

        def prep(sqe, ud, chunk=chunk, offset=offset):
            prep_write(sqe, self.fd, memoryview(chunk), offset, len(chunk),
                       flags=link)
            if mode == "passthru":
                sqe.cmd = "passthru"
            self._req_len[ud] = len(chunk)
        return IoRequest(prep)

    def _fsync_req(self, mode: str) -> IoRequest:
        def prep(sqe, ud):
            prep_fsync(sqe, self.fd, nvme_flush=(mode == "passthru"))
        self.stats.fsyncs += 1
        return IoRequest(prep)

    # ---------------------------------------------------------- truncate

    def truncate_to(self, lsn: int) -> int:
        """Reclaim log space below ``lsn`` (a record boundary — the
        caller derives it from the checkpoint's min recLSN and the
        oldest in-flight txn's BEGIN; see StorageEngine.checkpoint).

        Whole blocks strictly below ``lsn`` are zeroed on the device and
        the header block is rewritten with the new ``truncated_lsn`` so
        a post-crash ``scan_log`` starts there instead of reading zeroes
        as a torn record.  Like the bootstrap header write, the device
        image is updated directly (a real WAL would recycle segment
        files; our LSNs are absolute byte offsets).  Returns the number
        of bytes reclaimed."""
        lsn = min(lsn, self.durable_lsn)
        if lsn <= self.truncated_lsn:
            return 0
        lo = (self.truncated_lsn // BLOCK) * BLOCK
        hi = (lsn // BLOCK) * BLOCK
        if hi > lo:
            zero = bytes(hi - max(lo, BLOCK))
            self.disk.image[max(lo, BLOCK):hi] = zero
            self.buf[max(lo, BLOCK):hi] = zero
        self.truncated_lsn = lsn
        self.header.truncated_lsn = lsn
        hdr_block = encode_header(self.header)
        self.buf[:BLOCK] = hdr_block
        self.disk.image[:BLOCK] = hdr_block
        self.stats.truncations += 1
        self.stats.bytes_reclaimed += max(0, hi - max(lo, BLOCK))
        return max(0, hi - max(lo, BLOCK))
