"""Guidelines advisor: diagnose ring misconfiguration from attribution.

The paper's §5 guidelines tell you *which* io_uring feature fixes
*which* kernel-side cost — but only if you can see where the cycles
go.  ``RingStats.attribution`` (built by ``repro.core.ring`` under a
conservation invariant) is exactly that breakdown; the advisor turns
it into findings, each naming the anti-pattern it detected, the paper
guideline it encodes, and the design-ladder rung that the committed
BENCH snapshots show fixing it:

  rule                    trigger                       rung that fixes it
  ----------------------  ----------------------------  ------------------
  shared-ring-lock        ring_lock share               +MultiCore(N)
  ipi-completions         ipi share                     +MultiCore(N)
                                                        (DEFER_TASKRUN)
  copied-big-sends        bounce_copy share AND mean    +zc_send (SEND_ZC)
                          copied send > ~1 KiB
  unbatched-submission    syscall share AND low         +BatchSubmit
                          batch_efficiency
  worker-fallbacks        fallback rate per SQE (GL3)   +GroupCommit /
                                                        +PassthruFlush
  storage-bounce          pin_copy share (GL4)          +RegBufs
  kernel-storage-stack    storage_stack share (GL4)     +Passthru
  irq-completions         complete_irq share (GL4)      +IOPoll
  speculative-recv-miss   sock_speculative share        POLL_FIRST
  buf-ring-exhaustion     terminated multishot recvs    larger buffer ring
  host-spill-bound        pager demand reads stall      +Prefetch(k)
                          decode, no read-ahead
  pager-read-bounce       pin_copy share on a paging    +RegBufs
                          read path (GL4)
  compaction-debt         host merge CPU on the         +KernelCompaction
                          foreground core               (or throttle)
  read-amp-bound          device probes per LSM         compact harder /
                          lookup > ~4                   wider blooms

``shared-ring-lock`` carries a structural severity boost: *any*
measurable ring-lock share means several cores are submitting to one
ring — the cardinal anti-pattern (§3.3 one-ring-per-thread; SteelDB's
kernel-contention stalls) that also invalidates SINGLE_ISSUER, so it
outranks the cost shares it drags in (IPIs included).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List

#: Fig. 16 crossover: below ~1 KiB the copy beats zc_setup, above it
#: zero-copy wins — the advisor only flags copies past the crossover
ZC_SEND_THRESHOLD = 1024


@dataclass
class RingReport:
    """What the advisor reads: merged attribution + the few counters
    that shares alone cannot express (rates, copy sizes)."""

    attribution: Dict[str, float] = field(default_factory=dict)
    cpu_seconds: float = 0.0
    enters: int = 0
    sqes_submitted: int = 0
    worker_fallbacks: int = 0
    sends_copied: int = 0
    send_bytes_copied: int = 0
    buf_ring_exhausted: int = 0
    # serving-tier pager signals (repro.serve.kv_paging result dicts);
    # pager_reads == 0 keeps the pager rules quiet for non-serving rings
    pager_reads: int = 0
    read_wait_frac: float = 0.0
    prefetch_depth: int = -1
    # fault-plane / error-recovery signals (PR 9): CQEs that carried a
    # real device/link error, total CQEs reaped for the rate, and the
    # semisync availability ledger.  All zero on a healthy ring, so the
    # robustness rules stay quiet everywhere else.
    error_cqes: int = 0
    cqes_reaped: int = 0
    semisync_degrades: int = 0
    repromotions: int = 0
    # LSM signals (repro.lsm result dicts): all zero/absent on a
    # non-LSM engine, so the LSM rules stay quiet everywhere else
    compaction_cpu_frac: float = 0.0   # merge CPU / wall time
    kernel_compaction: bool = False
    lsm_lookups: int = 0
    lsm_read_amp: float = 0.0          # device probes per lookup
    lsm_debt_max_mb: float = 0.0

    def share(self, cat: str) -> float:
        total = sum(self.attribution.values())
        return self.attribution.get(cat, 0.0) / total if total > 0 else 0.0

    def batch_efficiency(self) -> float:
        return self.sqes_submitted / max(1, self.enters)

    def mean_copied_send(self) -> float:
        return self.send_bytes_copied / self.sends_copied \
            if self.sends_copied else 0.0


@dataclass
class Finding:
    rule: str           # stable id, e.g. "shared-ring-lock"
    rung: str           # the design-ladder rung that fixes it
    guideline: str      # the paper guideline this rule encodes
    severity: float     # cost share (or rate), higher = worse
    detail: str

    def __str__(self):
        return (f"[{self.rule}] {self.detail} -> {self.rung} "
                f"({self.guideline})")


def report_from_stats(stats: Iterable) -> RingReport:
    """Merge one or more ``RingStats`` into a report."""
    rep = RingReport()
    for st in stats:
        for k, v in st.attribution.items():
            rep.attribution[k] = rep.attribution.get(k, 0.0) + v
        rep.cpu_seconds += st.cpu_seconds_app + st.cpu_seconds_sqpoll
        rep.enters += st.enters
        rep.sqes_submitted += st.sqes_submitted
        rep.worker_fallbacks += st.worker_fallbacks
        rep.sends_copied += st.sends_copied
        rep.send_bytes_copied += st.send_bytes_copied
        rep.buf_ring_exhausted += st.buf_ring_exhausted
        rep.error_cqes += st.error_cqes
        rep.cqes_reaped += st.cqes_reaped
    return rep


def report_from_result(res: dict) -> RingReport:
    """Build a report from an engine result dict (``run_fibers`` /
    ``ShuffleEngine.run``) — the machine-readable bench path."""
    return RingReport(
        attribution=dict(res.get("attribution", {})),
        cpu_seconds=res.get("app_cpu_s", 0.0) +
        res.get("sqpoll_cpu_s", 0.0),
        enters=res.get("enters", 0),
        sqes_submitted=int(res.get("batch_eff", 0.0) *
                           res.get("enters", 0)),
        worker_fallbacks=res.get("worker_fallbacks", 0),
        sends_copied=res.get("sends_copied", 0),
        send_bytes_copied=res.get("send_bytes_copied", 0),
        buf_ring_exhausted=res.get("buf_ring_exhausted", 0),
        pager_reads=res.get("pager_reads", 0),
        read_wait_frac=res.get("read_wait_frac", 0.0),
        prefetch_depth=res.get("prefetch_k", -1),
        error_cqes=res.get("error_cqes", 0),
        cqes_reaped=res.get("cqes_reaped",
                            int(res.get("batch_eff", 0.0) *
                                res.get("enters", 0))),
        semisync_degrades=res.get("semisync_degrades", 0),
        repromotions=res.get("repromotions", 0),
        compaction_cpu_frac=res.get("compaction_cpu_frac", 0.0),
        kernel_compaction=res.get("kernel_compaction", False),
        lsm_lookups=res.get("lookups", 0),
        lsm_read_amp=res.get("read_amp", 0.0),
        lsm_debt_max_mb=res.get("debt_max_mb", 0.0))


def diagnose(rep: RingReport) -> List[Finding]:
    """All firing rules, most severe first (an empty list = 'ok')."""
    out: List[Finding] = []

    s = rep.share("ring_lock")
    if s > 0.01:
        out.append(Finding(
            "shared-ring-lock", "+MultiCore(N)",
            "§3.3 one ring per core (SINGLE_ISSUER)", 1.0 + s,
            f"ring_lock burns {s:.0%} of kernel CPU: several cores "
            f"contend on one ring's SQ lock"))

    s = rep.share("ipi")
    if s > 0.02:
        out.append(Finding(
            "ipi-completions", "+MultiCore(N)",
            "§2.2 DEFER_TASKRUN (reap inside enter, no preemption)", s,
            f"completion IPIs preempt the app core for {s:.0%} of "
            f"kernel CPU: task work runs in default mode"))

    s = rep.share("bounce_copy")
    if s > 0.10 and rep.mean_copied_send() > ZC_SEND_THRESHOLD:
        out.append(Finding(
            "copied-big-sends", "+zc_send",
            "Fig. 16 SEND_ZC past the ~1 KiB crossover", s,
            f"bounce copies burn {s:.0%} of kernel CPU at a mean "
            f"copied-send size of {rep.mean_copied_send():.0f} B"))

    be = rep.batch_efficiency()
    s = rep.share("syscall")
    if be < 4.0 and s > 0.05:
        out.append(Finding(
            "unbatched-submission", "+BatchSubmit",
            "§2.1 batched submission amortizes enter()", s,
            f"{be:.1f} SQEs/enter — the enter syscall is {s:.0%} of "
            f"kernel CPU"))

    rate = rep.worker_fallbacks / max(1, rep.sqes_submitted)
    if rate > 0.02:
        out.append(Finding(
            "worker-fallbacks", "+GroupCommit/+PassthruFlush",
            "GL3 keep blocking ops off the io_worker pool", rate,
            f"{rep.worker_fallbacks} of {rep.sqes_submitted} SQEs "
            f"({rate:.0%}) fell back to io_workers (+7.3 us each): "
            f"use linked write->fsync chains, NVMe flush, and "
            f"<= max-segment block sizes"))

    s = rep.share("pin_copy")
    if s > 0.02:
        out.append(Finding(
            "storage-bounce", "+RegBufs",
            "§3.4.1 registered buffers (GL4)", s,
            f"per-op pin+copy is {s:.0%} of kernel CPU: buffers are "
            f"not registered"))

    s = rep.share("storage_stack")
    if s > 0.10:
        out.append(Finding(
            "kernel-storage-stack", "+Passthru",
            "§3.4.1 NVMe passthrough (GL4)", s,
            f"the generic storage stack is {s:.0%} of kernel CPU"))

    s = rep.share("complete_irq")
    if s > 0.10:
        out.append(Finding(
            "irq-completions", "+IOPoll",
            "§3.4.1 completion polling (GL4)", s,
            f"interrupt-driven completion handling is {s:.0%} of "
            f"kernel CPU"))

    s = rep.share("sock_speculative")
    if s > 0.05:
        out.append(Finding(
            "speculative-recv-miss", "POLL_FIRST",
            "§4.1 skip the speculative inline recv attempt", s,
            f"wasted speculative recv attempts are {s:.0%} of kernel "
            f"CPU"))

    if rep.pager_reads > 0 and rep.prefetch_depth == 0 \
            and rep.read_wait_frac > 0.35:
        out.append(Finding(
            "host-spill-bound", "+Prefetch(k)",
            "§3.4 overlap spill reads with compute (read-ahead fibers)",
            rep.read_wait_frac,
            f"decode fibers spend {rep.read_wait_frac:.0%} of their "
            f"time blocked on demand pager reads and no read-ahead is "
            f"configured: spill latency is serialized into every token"))

    s = rep.share("pin_copy")
    if rep.pager_reads > 0 and s > 0.02:
        out.append(Finding(
            "pager-read-bounce", "+RegBufs",
            "§3.4.1 registered frames for the paging read path (GL4)", s,
            f"{rep.pager_reads} pager reads paid per-op pin+copy "
            f"({s:.0%} of kernel CPU): KV frames are not registered"))

    if rep.buf_ring_exhausted > 0:
        out.append(Finding(
            "buf-ring-exhaustion", "larger provided buffer ring",
            "§4.2 size the buffer ring to the burst", 0.01,
            f"{rep.buf_ring_exhausted} multishot recvs terminated "
            f"with EAGAIN for lack of a provided buffer"))

    # ---------------------------------------- robustness rules (PR 9)
    err_rate = rep.error_cqes / max(1, rep.cqes_reaped)
    if err_rate > 0.005:
        out.append(Finding(
            "transient-error-storm", "retry budgets + capped backoff",
            "errors are a completion, not an exception: every CQE "
            "res must be checked", 1.0 + err_rate,
            f"{rep.error_cqes} of {rep.cqes_reaped} CQEs "
            f"({err_rate:.1%}) completed with a device/link error: "
            f"the device or link is degraded — retries mask it at a "
            f"latency cost, so investigate before raising budgets"))

    # ----------------------------------------------- LSM rules (PR 10)
    if rep.compaction_cpu_frac > 0.05 and not rep.kernel_compaction:
        s = rep.compaction_cpu_frac
        out.append(Finding(
            "compaction-debt", "+KernelCompaction (or throttle writes)",
            "§4.3 background work shares the foreground's core: "
            "offload or pace it", s,
            f"host-side compaction merges burn {s:.0%} of wall-clock "
            f"CPU on the foreground core (peak debt "
            f"{rep.lsm_debt_max_mb:.1f} MB): every merge slice lands "
            f"in the OLTP tail — offload the merge kernel-side or "
            f"throttle the write rate"))

    if rep.lsm_lookups > 0 and rep.lsm_read_amp > 4.0:
        s = min(1.0, rep.lsm_read_amp / 10.0)
        out.append(Finding(
            "read-amp-bound", "compact harder / widen bloom filters",
            "bound per-lookup device probes: bloom bits + leveling "
            "keep read-amp O(1)", s,
            f"lookups probe {rep.lsm_read_amp:.1f} data pages each "
            f"(over {rep.lsm_lookups} lookups): L0 is too deep or the "
            f"bloom filters pass too many tables — lower the L0 "
            f"trigger, raise bloom bits/key, or give compaction more "
            f"headroom"))

    if rep.semisync_degrades > 0:
        back = (f"re-promoted {rep.repromotions}x"
                if rep.repromotions else "still degraded")
        out.append(Finding(
            "semisync-degraded", "standby/link capacity (or a longer "
            "ack timeout)",
            "availability over replication durability: a stalled "
            "standby must not stall commits", 0.5 + rep.semisync_degrades,
            f"semisync fell back to async acking "
            f"{rep.semisync_degrades}x ({back}): commits acked without "
            f"a standby-durable copy during the degraded window"))

    out.sort(key=lambda f: -f.severity)
    return out
