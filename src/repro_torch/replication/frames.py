"""Wire framing for WAL log shipping.

The ship stream is a byte stream chopped into wire chunks (each chunk
is one SEND/SEND_ZC, sized against the NIC's zero-copy threshold), so a
frame routinely straddles chunk boundaries and a chunk may carry the
tails and heads of several frames.  ``FrameAssembler`` reassembles the
stream on the standby and is the crash-safety boundary: a frame is
surfaced only when complete AND CRC-valid, so a primary dying mid-ship
leaves exactly the torn suffix in the assembler — never a partially
applied span — and a corrupted chunk poisons the stream at the first
bad CRC instead of desynchronizing silently.

Frame layout (little-endian)::

    [0:4]    u32  crc32 of bytes [4:size)
    [4:8]    u32  size (total frame bytes, incl. this header)
    [8]      u8   FrameKind
    [9:17]   u64  lsn_lo   (span start | ack durable_lsn)
    [17:25]  u64  lsn_hi   (span end   | ack applied_lsn)
    [25:]         payload  (WAL bytes | header block | b"\\x01" fin)

Mirrors the WAL's own record framing (crc+size prefix) on purpose: the
same torn-suffix rejection argument applies on the wire as on disk.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import Iterator, List

FRAME_HDR = struct.Struct("<IIBQQ")      # crc, size, kind, lsn_lo, lsn_hi


class FrameKind:
    HELLO = 1        # payload = the primary's 4 KiB WAL header block
    WAL_SPAN = 2     # payload = raw WAL bytes [lsn_lo, lsn_hi)
    ACK = 3          # lsn_lo = standby durable, lsn_hi = standby applied
    SHUTDOWN = 4     # clean end of stream (primary quiesced)

    _NAMES = {1: "HELLO", 2: "WAL_SPAN", 3: "ACK", 4: "SHUTDOWN"}

    @classmethod
    def name(cls, k: int) -> str:
        return cls._NAMES.get(k, f"?{k}")


@dataclass
class Frame:
    kind: int
    lsn_lo: int
    lsn_hi: int
    payload: bytes

    @property
    def size(self) -> int:
        return FRAME_HDR.size + len(self.payload)


def encode_frame(kind: int, lsn_lo: int = 0, lsn_hi: int = 0,
                 payload: bytes = b"") -> bytes:
    size = FRAME_HDR.size + len(payload)
    body = FRAME_HDR.pack(0, size, kind, lsn_lo, lsn_hi)[4:] + payload
    return struct.pack("<I", zlib.crc32(body)) + body


def chop(frame_bytes: bytes, chunk_bytes: int) -> Iterator[bytes]:
    """Split an encoded frame into wire chunks (the sender's MTU-ish
    send granularity)."""
    for off in range(0, len(frame_bytes), chunk_bytes):
        yield frame_bytes[off:off + chunk_bytes]


class FrameAssembler:
    """Streaming reassembly with torn-suffix rejection.

    ``feed(chunk)`` returns every frame COMPLETED by that chunk;
    residual bytes (a frame still missing its tail) stay buffered.  On
    a CRC mismatch or nonsense header the stream is marked ``corrupt``
    and everything from the bad frame on is dropped — the standby holds
    at the last fully-shipped frame, exactly like ``scan_log`` holds at
    the first torn record."""

    #: sanity bound on a single frame: larger than any flush span we
    #: could ship (the whole log device), so only a corrupted size
    #: field can exceed it — without this cap an upward bit flip in
    #: ``size`` would stall the stream forever "waiting for the tail"
    #: instead of poisoning it at the header check
    MAX_FRAME = 128 * 1024 * 1024

    def __init__(self, max_frame: int = MAX_FRAME):
        self._buf = bytearray()
        self.max_frame = max_frame
        self.corrupt = False
        self.frames_in = 0
        self.bytes_in = 0

    def feed(self, chunk: bytes) -> List[Frame]:
        if self.corrupt:
            return []                    # stream is dead past the tear
        self._buf += chunk
        self.bytes_in += len(chunk)
        out: List[Frame] = []
        while len(self._buf) >= FRAME_HDR.size:
            crc, size, kind, lo, hi = FRAME_HDR.unpack_from(self._buf, 0)
            if size < FRAME_HDR.size or size > self.max_frame or \
                    kind not in FrameKind._NAMES:
                self.corrupt = True
                break
            if len(self._buf) < size:
                break                    # frame tail still on the wire
            if zlib.crc32(self._buf[4:size]) != crc:
                self.corrupt = True
                break
            out.append(Frame(kind, lo, hi,
                             bytes(self._buf[FRAME_HDR.size:size])))
            del self._buf[:size]
        self.frames_in += len(out)
        return out

    def torn_bytes(self) -> int:
        """Bytes held back as an incomplete (or corrupt) suffix."""
        return len(self._buf)

    def reset(self) -> None:
        """Connection reset: drop the partial suffix.  The sender only
        ever loses a contiguous *suffix* of its sends (the simulated
        link fails atomically per chunk), so the buffered bytes are a
        frame head whose tail never arrived — the peer re-sends the
        whole frame after reconnecting, and the stream resumes on a
        clean frame boundary.  This is NOT corruption: ``corrupt``
        stays untouched (a CRC tear still poisons the stream)."""
        self._buf.clear()
