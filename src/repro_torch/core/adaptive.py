"""Submission batching policies (paper §3.3.3, adaptive batching).

``AdaptiveBatcher`` adjusts the flush threshold from the ratio of
outstanding I/Os to runnable fibers: when many I/Os are in flight the
device is busy, so defer submission to grow the batch (amortization);
when few are pending, flush immediately to avoid starving the device and
emptying the ready queue.
"""

from __future__ import annotations

from dataclasses import dataclass


class SubmitPolicy:
    def should_flush(self, *, queued: int, inflight: int, ready: int) -> bool:
        raise NotImplementedError


@dataclass
class EagerSubmit(SubmitPolicy):
    """One enter per I/O — the paper's naive baseline."""

    def should_flush(self, *, queued, inflight, ready):
        return queued > 0


@dataclass
class FixedBatch(SubmitPolicy):
    batch: int = 16

    def should_flush(self, *, queued, inflight, ready):
        return queued >= self.batch or ready == 0


@dataclass
class AdaptiveFlush(SubmitPolicy):
    """Group-commit flush decision (ROADMAP: the paper's adaptive
    batching signal applied to the WAL).  The leader reuses the
    ``SubmitPolicy`` shape with the same semantics tilted toward
    durability: ``queued`` is the number of commit LSNs waiting,
    ``inflight`` the I/Os outstanding on the engine's rings, ``ready``
    the runnable fibers.  An idle device means the flush would complete
    immediately — take the latency win; a busy device means committers
    keep arriving while earlier I/O drains — defer and grow the group."""
    min_group: int = 2
    max_group: int = 64

    def should_flush(self, *, queued, inflight, ready):
        if inflight == 0:
            return True               # device idle: flush now (latency)
        target = self.min_group + (self.max_group - self.min_group) * \
            min(1.0, inflight / max(1, inflight + ready))
        return queued >= target


@dataclass
class AdaptiveBatcher(SubmitPolicy):
    """Flush when (a) the ready queue ran dry (device must not starve),
    or (b) the batch has grown past a target that scales with how busy
    the device already is."""
    min_batch: int = 4
    max_batch: int = 64

    def should_flush(self, *, queued, inflight, ready):
        if ready == 0:
            return True
        # device nearly idle -> flush small batches; busy -> defer
        target = self.min_batch + (self.max_batch - self.min_batch) * \
            min(1.0, inflight / max(1, inflight + ready))
        return queued >= target
