"""The primary's log-sender fiber.

Taps the WAL's flush hook (``WriteAheadLog.on_flush`` — the group-commit
leader's flushes fire it, see ``repro.wal.group_commit``): each time the
durable horizon advances, the newly durable byte span [prev, new) is
framed (CRC + span LSNs, ``repro.replication.frames``) and chopped into
wire chunks.  All chunks of a span are staged and submitted as ONE
``io_uring_enter`` — the same earned batching as the shuffle's
destination staging.  Per chunk the sender picks the paper's Fig. 16
crossover: SEND_ZC above the NIC's ~1 KiB zero-copy threshold (pinned
buffer, deferred ZC_NOTIF CQE reaped via ``StreamRead``, bounded by a
small in-flight budget exactly like a real engine must double-buffer),
plain copied SEND below it.

Shipping is asynchronous by construction — it rides *behind* local
durability in every mode; the replication MODE only decides what the
commit path waits for (see ``repro.replication.cluster``).
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Optional

from repro_torch.core.fibers import Gate, IoRequest, StreamRead
from repro_torch.core.ring import prep_send, prep_timeout
from repro_torch.core.sqe import CqeFlags
from repro_torch.replication.frames import FrameKind, chop, encode_frame
from repro_torch.wal.log import encode_header


class LogSender:
    """Ships the primary WAL's durable spans over one SimSocket."""

    #: reconnect backoff after a failed ship (link flap): exponential
    #: from BASE, capped — sized against SimSocket's flap_duration so a
    #: couple of retries ride out one flap
    BACKOFF_BASE = 50e-6
    BACKOFF_CAP = 5e-3

    def __init__(self, engine, ship_fd: int, *, chunk_bytes: int = 4096,
                 zc_ship: str = "auto", zc_threshold: int = 1024,
                 max_pinned: int = 8):
        assert zc_ship in ("auto", "on", "off")
        self.engine = engine
        self.ship_fd = ship_fd
        self.chunk_bytes = chunk_bytes
        self.zc_ship = zc_ship
        self.zc_threshold = zc_threshold
        self.max_pinned = max_pinned
        self.gate = Gate(engine.sched)
        self.shipped = engine.wal.truncated_lsn   # == BLOCK at attach
        self._notifs: deque = deque()             # pending ZC_NOTIF uds
        self.frames = 0
        self.chunks = 0
        self.zc_chunks = 0
        self.ship_bytes = 0
        self.enters_before = 0
        # error recovery: on a connection reset the sender backs off,
        # then resumes shipping from the standby's last ACKED durable
        # LSN (resume_from, installed by the cluster) — never beyond
        # what it was about to send, never below the truncation point.
        # The standby tolerates the overlap (it slices re-shipped spans
        # to the suffix past its own end_lsn).
        self.resume_from: Optional[Callable[[], int]] = None
        self.send_errors = 0          # chunk CQEs that came back < 0
        self.reconnects = 0           # backoff+resume cycles
        self._fails = 0               # consecutive failures (backoff)
        engine.wal.on_flush.append(self._on_flush)

    # ------------------------------------------------------------------

    def _on_flush(self, lo: int, hi: int) -> None:
        """WAL flush hook: durable horizon moved — wake the sender."""
        self.gate.open()

    def _use_zc(self, n: int) -> bool:
        if self.zc_ship == "on":
            return True
        if self.zc_ship == "off":
            return False
        return n >= self.zc_threshold         # Fig. 16 crossover

    # ------------------------------------------------------------------

    def run(self, stop: Optional[Callable[[], bool]] = None):
        """The sender fiber.  Ships until ``stop()`` holds AND the whole
        log is durable and shipped, then sends SHUTDOWN; performs the
        clean-shutdown flush itself so a quiesced primary and standby
        end byte-identical."""
        wal = self.engine.wal
        # HELLO: the primary's header block makes the standby's log
        # self-describing with the same geometry (base-backup handshake)
        yield from self._ship_retrying(encode_frame(
            FrameKind.HELLO, 0, 0, encode_header(wal.header)))
        while True:
            hi = wal.durable_lsn
            if self.shipped < hi:
                lo = self.shipped
                span = bytes(wal.buf[lo:hi])
                ok = yield from self._ship_frame(encode_frame(
                    FrameKind.WAL_SPAN, lo, hi, span))
                if ok:
                    self.shipped = hi
                else:
                    # link flap: back off, then resume from the
                    # standby's acked durable horizon (the reset
                    # dropped its partial frame; everything past the
                    # ack must be re-shipped)
                    yield from self._backoff()
                    self.reconnects += 1
                    resume = lo if self.resume_from is None \
                        else self.resume_from()
                    self.shipped = max(wal.truncated_lsn,
                                       min(lo, resume))
            elif stop is None or stop():
                if wal.end_lsn > wal.durable_lsn:
                    # clean shutdown: flush the tail (trailing APPLY /
                    # APPLY_END records), which re-enters the loop above
                    yield from wal.flush_to(wal.end_lsn)
                    continue
                break
            else:
                yield self.gate        # parked until the next flush
        yield from self._ship_retrying(encode_frame(FrameKind.SHUTDOWN))
        while self._notifs:            # release remaining pinned buffers
            yield StreamRead(self._notifs.popleft())

    def _ship_retrying(self, frame: bytes):
        """Ship a control frame (HELLO/SHUTDOWN), retrying across link
        flaps until it lands — the stream cannot proceed without it."""
        while True:
            ok = yield from self._ship_frame(frame)
            if ok:
                return
            yield from self._backoff()
            self.reconnects += 1

    def _backoff(self):
        """Sleep out (part of) a link flap: one TIMEOUT SQE, doubling
        per consecutive failure up to the cap.  ETIME on the CQE is the
        timer FIRING, not an error."""
        delay = min(self.BACKOFF_CAP,
                    self.BACKOFF_BASE * 2 ** min(self._fails, 8))
        self._fails += 1

        def prep(sqe, ud, d=delay):
            prep_timeout(sqe, d)
        yield IoRequest(prep)

    def _ship_frame(self, frame: bytes):
        """Chop one frame into wire chunks and submit them as one batch
        (one enter); reap ZC notifications beyond the pinned budget.
        Returns True if every chunk landed; a connection reset fails
        the contiguous suffix of the batch (the delivered prefix stays
        a valid stream prefix) and the peer's assembler drops the torn
        frame head, so the caller re-ships the WHOLE frame."""
        reqs = []
        for chunk in chop(frame, self.chunk_bytes):
            zc = self._use_zc(len(chunk))
            self.chunks += 1
            self.zc_chunks += zc
            self.ship_bytes += len(chunk)

            def prep(sqe, ud, chunk=chunk, zc=zc):
                prep_send(sqe, self.ship_fd, len(chunk), zero_copy=zc,
                          buf=memoryview(chunk))
            reqs.append(IoRequest(prep))
        self.frames += 1
        cqes = yield reqs
        ok = True
        for c in cqes:
            if c.res < 0:                      # ECONNRESET: chunk lost
                ok = False
                self.send_errors += 1
                continue
            if c.flags & CqeFlags.MORE:        # SEND_ZC: notif pending
                self._notifs.append(c.user_data)
        while len(self._notifs) > self.max_pinned:
            yield StreamRead(self._notifs.popleft())
        if ok:
            self._fails = 0
        return ok
