"""Submission/completion queue entries — the io_uring wire format, adapted.

Opcode and flag names follow ``io_uring.h`` so the mapping to the paper is
one-to-one.  A few TPU-framework-specific opcodes are added (DEVICE_PUT,
DEVICE_GET) for the host↔accelerator staging path; they behave like READ/WRITE
against a "device memory" backend.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


class Op(enum.IntEnum):
    NOP = 0
    READV = 1            # read into a plain (unregistered) buffer
    WRITEV = 2           # write from a plain buffer
    READ_FIXED = 3       # read into a registered buffer slot
    WRITE_FIXED = 4      # write from a registered buffer slot
    FSYNC = 5            # durability barrier (blocking -> io_worker path)
    SEND = 6
    RECV = 7
    SEND_ZC = 8          # zero-copy send (pinned user memory, no bounce copy)
    RECV_ZC = 9          # zero-copy receive (NIC header split; payload DMA'd)
    TIMEOUT = 10
    LINK_TIMEOUT = 11    # bounds the linked previous op
    URING_CMD = 12       # NVMe passthrough (bypasses the generic storage stack)
    POLL_ADD = 13


#: op -> op class for cost attribution and latency histograms; batch-
#: level charges that belong to no single op (enter syscall, ring lock,
#: task work, IPIs, completion handling) use the pseudo-class "ring"
_OP_CLASS = {
    Op.NOP: "nop",
    Op.READV: "read", Op.READ_FIXED: "read",
    Op.WRITEV: "write", Op.WRITE_FIXED: "write",
    Op.FSYNC: "fsync",
    Op.SEND: "send", Op.SEND_ZC: "send",
    Op.RECV: "recv", Op.RECV_ZC: "recv",
    Op.TIMEOUT: "timeout", Op.LINK_TIMEOUT: "timeout",
    Op.URING_CMD: "cmd",
    Op.POLL_ADD: "poll",
}


def op_class(op: Op) -> str:
    return _OP_CLASS.get(op, "other")


class SqeFlags(enum.IntFlag):
    NONE = 0
    IO_LINK = enum.auto()       # next SQE starts only after this one completes
    ASYNC = enum.auto()         # force the io_worker path
    MULTISHOT = enum.auto()     # one SQE, many CQEs (recv)
    POLL_FIRST = enum.auto()    # skip the speculative inline attempt
    FIXED_FILE = enum.auto()    # fd is an index into the registered-file table
    BUFFER_SELECT = enum.auto() # kernel picks a buffer from sqe.buf_group's
                                # provided buffer ring (paper §4.2)


class SetupFlags(enum.IntFlag):
    NONE = 0
    SQPOLL = enum.auto()        # kernel-side submission polling thread
    IOPOLL = enum.auto()        # completion polling from the device queue
    DEFER_TASKRUN = enum.auto() # reap completions only inside enter (recommended)
    COOP_TASKRUN = enum.auto()  # suppress IPIs, still reap on any transition
    SINGLE_ISSUER = enum.auto() # one submitting thread (enables internal opts)


class CqeFlags(enum.IntFlag):
    NONE = 0
    WORKER = enum.auto()     # completed on the io_worker fallback path (slow!)
    INLINE = enum.auto()     # completed inline during submission
    POLLED = enum.auto()     # completed via the poll set
    MORE = enum.auto()       # multishot: more CQEs will follow
    ZC_NOTIF = enum.auto()   # zero-copy send: buffer-release notification


# errno-style results (negative in CQE.res, like io_uring)
ECANCELED = -125
ETIME = -62
EINVAL = -22
EAGAIN = -11
EIO = -5
ENOENT = -2
ENOTSUP = -95
ECONNRESET = -104


@dataclass
class SQE:
    op: Op = Op.NOP
    fd: int = -1
    offset: int = 0
    length: int = 0
    buf: Any = None            # memoryview / np.ndarray / bytes
    buf_index: int = -1        # registered-buffer slot for *_FIXED ops
    buf_group: int = -1        # provided-buffer-ring group (BUFFER_SELECT)
    user_data: int = 0
    flags: SqeFlags = SqeFlags.NONE
    timeout: Optional[float] = None   # for TIMEOUT / LINK_TIMEOUT (seconds)
    cmd: Any = None            # URING_CMD payload (e.g. ("flush",))

    def clear(self) -> None:
        self.__init__()


@dataclass
class CQE:
    user_data: int = 0
    res: int = 0
    flags: CqeFlags = CqeFlags.NONE
    buf_id: int = -1           # provided-buffer slot this CQE consumed
    # not in the ABI, but handy for analysis/benchmarks:
    t_complete: float = 0.0
    t_submit: float = 0.0

    @property
    def latency(self) -> float:
        return self.t_complete - self.t_submit


class LatHist:
    """Log2-bucketed latency histogram: O(1) record, ~percent-accurate
    percentiles — cheap enough to run on every CQE unconditionally.
    Bucket ``b`` holds latencies in ``(FLOOR*2^(b-1), FLOOR*2^b]``."""

    __slots__ = ("counts", "n", "total_s")

    FLOOR = 1e-8                   # 10 ns
    NBUCKETS = 40                  # covers up to ~5000 s

    def __init__(self):
        self.counts = [0] * self.NBUCKETS
        self.n = 0
        self.total_s = 0.0

    def record(self, seconds: float) -> None:
        if seconds < 0.0:
            seconds = 0.0
        self.n += 1
        self.total_s += seconds
        b = 0
        if seconds > self.FLOOR:
            b = min(self.NBUCKETS - 1,
                    int(math.ceil(math.log2(seconds / self.FLOOR))))
        self.counts[b] += 1

    def percentile(self, p: float) -> float:
        """Geometric-midpoint estimate of the p-th percentile (seconds)."""
        if self.n == 0:
            return 0.0
        target = p / 100.0 * self.n
        cum = 0
        for b, c in enumerate(self.counts):
            cum += c
            if cum >= target:
                if b == 0:
                    return self.FLOOR / 2
                return math.sqrt((self.FLOOR * 2 ** (b - 1)) *
                                 (self.FLOOR * 2 ** b))
        return self.FLOOR * 2 ** (self.NBUCKETS - 1)

    def p50(self) -> float:
        return self.percentile(50.0)

    def p99(self) -> float:
        return self.percentile(99.0)

    def mean(self) -> float:
        return self.total_s / self.n if self.n else 0.0


@dataclass
class RingStats:
    """Counters used by benchmarks and by the guideline checks (GL3: a high
    worker-fallback rate indicates a suboptimal I/O pattern).

    ``attribution`` is the kernel-cost breakdown: every cost the ring
    charges lands in exactly one category (see ``CostModel.CATEGORIES``)
    so that ``sum(attribution.values()) ==
    cpu_seconds_app + cpu_seconds_sqpoll`` to float epsilon — the
    conservation invariant the observability layer (and check.sh) rests
    on.  ``op_attribution`` splits the same seconds by op class
    ('read', 'write', 'send', ..., 'ring' for batch-level charges)."""

    enters: int = 0
    sqes_submitted: int = 0
    cqes_reaped: int = 0
    inline_completions: int = 0
    polled_completions: int = 0
    worker_fallbacks: int = 0
    sqpoll_wakeups: int = 0
    bounce_bytes_copied: int = 0   # kernel<->user copies avoided by RegBufs/ZC
    cpu_seconds_app: float = 0.0   # CPU charged to the application core
    cpu_seconds_sqpoll: float = 0.0
    #: MORE-flagged CQEs of multishot RECVs only — SEND_ZC's MORE-flagged
    #: request completion is deliberately NOT counted here (its deferred
    #: buffer release is ``zc_notifs``); see test_observability.py
    multishot_recv_cqes: int = 0
    zc_notifs: int = 0             # SEND_ZC buffer-release notifications
    zc_notif_cqes_reaped: int = 0  # of cqes_reaped: ZC_NOTIF (not data)
    buf_ring_exhausted: int = 0    # recvs terminated for lack of a buffer
    sends_copied: int = 0          # non-ZC sends that bounced (advisor)
    send_bytes_copied: int = 0     # bytes those sends copied
    passthru_cmds: int = 0         # ops issued as NVMe io_uring-cmd
                                   # (passthrough reads/writes/flushes)
    # fault plane / error-recovery surfaces (PR 9).  error_cqes counts
    # CQEs carrying a real device/link error (EIO, ECONNRESET, ENOTSUP,
    # or a device-side ETIME — pacing TIMEOUT ops and cancels are not
    # errors); short_cqes counts partial I/O completions
    # (0 < res < requested length); passthru_fallbacks counts uring-cmd
    # ops that a subsystem degraded to the regular read/fsync path
    # after ENOTSUP or a timeout (bumped by the recovering subsystem).
    error_cqes: int = 0
    short_cqes: int = 0
    passthru_fallbacks: int = 0
    # LSM read path (repro.lsm): SSTable data pages actually probed per
    # level ("L0", "L1", ...) — the per-level read-amplification
    # surface — and lookups a bloom filter answered negatively without
    # touching the device
    lsm_level_reads: Dict[str, int] = field(default_factory=dict)
    lsm_bloom_skips: int = 0
    # kernel-cost attribution (seconds; see class docstring)
    attribution: Dict[str, float] = field(default_factory=dict)
    op_attribution: Dict[str, Dict[str, float]] = field(
        default_factory=dict)
    # per-op-class completion-latency histograms (CQE.latency)
    lat: Dict[str, LatHist] = field(default_factory=dict)

    def batch_efficiency(self) -> float:
        return self.sqes_submitted / max(1, self.enters)

    @property
    def multishot_cqes(self) -> int:
        """Deprecated alias for ``multishot_recv_cqes``."""
        return self.multishot_recv_cqes

    @property
    def data_cqes_reaped(self) -> int:
        """Of ``cqes_reaped``: CQEs carrying data/results, i.e. not
        SEND_ZC buffer-release notifications."""
        return self.cqes_reaped - self.zc_notif_cqes_reaped

    def attribute(self, cat: str, op_cls: str, seconds: float) -> None:
        self.attribution[cat] = self.attribution.get(cat, 0.0) + seconds
        per_op = self.op_attribution.setdefault(op_cls, {})
        per_op[cat] = per_op.get(cat, 0.0) + seconds

    def attributed_seconds(self) -> float:
        return sum(self.attribution.values())

    def record_latency(self, op_cls: str, seconds: float) -> None:
        h = self.lat.get(op_cls)
        if h is None:
            h = self.lat[op_cls] = LatHist()
        h.record(seconds)

    def latency_summary(self) -> Dict[str, Dict[str, float]]:
        """{op_class: {n, p50_us, p99_us, mean_us}} for benchmarks."""
        return {cls: {"n": h.n,
                      "p50_us": h.p50() * 1e6,
                      "p99_us": h.p99() * 1e6,
                      "mean_us": h.mean() * 1e6}
                for cls, h in self.lat.items()}
