"""CPU cost model for the simulated kernel I/O path.

Constants are cycles on the paper's 3.7 GHz AMD machine, derived from
Table 1 and the §2.1 batching chart:

  single read  10 200 clk   = syscall + kernel-submit floor
  batch  read   5 400 clk   = floor + syscall/16
  batch  write  5 700 clk

Solving: syscall ≈ 5 120 clk, read floor ≈ 5 080, write floor ≈ 5 380.
Tuning features subtract measured deltas (§3.4.1): registered buffers
(-11% tx/s ⇒ ~700 clk/op pin+copy), NVMe passthrough (-20% ⇒ ~3 200 clk
storage-stack), IOPoll (-21% ⇒ interrupt cost ~2 600 clk), SQPoll removes
the syscall from the app core entirely (+32%).
"""

from __future__ import annotations

from dataclasses import dataclass


#: attribution categories: every cost the ring charges is tagged with
#: exactly one of these, so RingStats.attribution sums back to
#: cpu_seconds_app + cpu_seconds_sqpoll (the conservation invariant the
#: observability layer rests on — see docs/observability.md)
CATEGORIES = (
    "syscall",          # io_uring_enter
    "submit_floor",     # per-SQE kernel submission floor
    "task_work",        # placing the CQE
    "complete_irq",     # interrupt-driven completion handling
    "complete_poll",    # IOPoll completion reap
    "ipi",              # default task-work mode: preemption IPI
    "ring_lock",        # shared-ring anti-pattern: SQ lock handoff
    "bounce_copy",      # kernel<->user socket copies (non-ZC send/recv)
    "pin_copy",         # storage per-op pin+copy (no registered buffers)
    "storage_stack",    # generic storage stack (no NVMe passthrough)
    "sock_submit",      # socket submission work
    "sock_speculative", # wasted speculative inline recv attempt
    "zc_setup",         # zero-copy / fixed-buffer registration per op
    "sqpoll",           # SQPoll thread's submission polling
    "kernel_compaction",  # +KernelCompaction rung: in-kernel (eBPF-style)
                          # LSM merge cycles + bounce copies, charged
                          # kernel-side (no fiber-core occupancy)
)


@dataclass
class CostModel:
    clock_hz: float = 3.7e9
    # submission / completion
    syscall: int = 5_120          # one io_uring_enter
    submit_floor_nop: int = 600
    submit_floor_read: int = 3_000
    submit_floor_write: int = 3_300
    complete_irq: int = 2_600     # interrupt-driven completion handling
    complete_polled: int = 260    # IOPoll: reap from device queue
    task_work: int = 300          # place CQE (DeferTR: inside enter)
    preempt_ipi: int = 1_800      # default mode: IPI preemption (CoopTR: 0)
    ring_lock: int = 400          # shared-ring anti-pattern: lock handoff
                                  # (cache-line transfer + CAS) per enter
                                  # on a ring submitted to by many cores
    # per-op feature deltas
    pin_copy: int = 700           # avoided by registered buffers (storage)
    storage_stack: int = 3_200    # avoided by NVMe passthrough
    # networking (per send/recv; Fig. 15/16)
    sock_submit: int = 2_000
    sock_speculative: int = 900   # wasted inline attempt (POLL_FIRST skips)
    copy_per_byte: float = 1.5    # kernel copy incl. skb alloc, cycles/B
    # (crossover vs zc_setup at ~1 KiB — paper Fig. 16 threshold)
    # beyond the first few KiB the skb set-up cost is amortized and the
    # copy runs at streaming-memcpy rate (~40 GB/s): 1 MiB shuffle chunks
    # cost ~28 µs to bounce, not the 425 µs a flat 1.5 cyc/B would charge
    copy_small_bytes: int = 4_096
    copy_bulk_per_byte: float = 0.0925
    zc_setup: int = 1_500         # zero-copy registration per op
    multishot_amort: int = 1_200  # saved per recv after the first
    # LSM compaction merge (repro.lsm): decode + compare + re-encode +
    # CRC per merged entry; charged to the app core (host compaction)
    # or kernel-side under the +KernelCompaction rung
    lsm_merge_entry: int = 3_000
    # io_worker fallback (§2.2: +7.3 µs measured)
    worker_overhead_s: float = 7.3e-6
    sqpoll_wake_s: float = 30e-6  # §2.2: waking the SQPoll thread
    sqpoll_idle_s: float = 100e-6  # sleep after idle timeout

    def s(self, cycles: float) -> float:
        return cycles / self.clock_hz

    def copy_cycles(self, nbytes: int) -> float:
        """Kernel<->user copy cost: skb-alloc rate for the head, bulk
        streaming rate for the remainder (keeps the Fig. 16 ~1 KiB
        zero-copy crossover while making MiB-scale bounces realistic)."""
        head = min(nbytes, self.copy_small_bytes)
        return self.copy_per_byte * head + \
            self.copy_bulk_per_byte * (nbytes - head)


DEFAULT_COSTS = CostModel()
