"""Primary→standby WAL log shipping on the ring runtime.

The paper's closing guidelines argue io_uring pays off most when a DBMS
puts storage AND network I/O on one interface and earns its batching
end-to-end (§6).  Replicated durability is the canonical workload that
needs both at once, and each rung of the replication ladder maps onto a
specific guideline:

* **unified rings** — the primary's WAL fsyncs, the ship-stream sends,
  and the ack recvs all run on the same SINGLE_ISSUER+DEFER_TASKRUN
  ring (the WAL leader's); the standby's recv/flush/apply runs on its
  own ring attached to the same scheduler.  No second event loop, no
  epoll sidecar — GL "one ring per thread, everything through it".
* **G-style batching** — ship spans are the group-commit leader's flush
  spans (one frame per flush, covering a whole commit group); all wire
  chunks of a span enter the kernel as ONE ``io_uring_enter``; standby
  acks piggyback per flush/apply batch, not per commit.  Batching is
  measured in ``RingStats.enters``, never assumed.
* **ZC threshold** — per chunk the sender picks SEND_ZC above the NIC's
  ~1 KiB zero-copy crossover (Fig. 16) and copied SEND below it;
  ZC_NOTIF completions bound the pinned-buffer budget exactly like the
  shuffle's double-buffered senders.
* **multishot + provided buffers** — the standby arms ONE multishot
  recv over a provided buffer ring for the whole stream (§4.2): a CQE
  per chunk, zero re-arm syscalls, EAGAIN on ring exhaustion.

Durability rungs (``EngineConfig.repl`` / the ladder entries):

* ``+AsyncRepl``  — commit acks after LOCAL durability; shipping rides
  behind.  Loss on failover is bounded by replication lag.
* ``+SemiSync``   — commit additionally waits for the standby's
  WAL-durable ack (remote_flush): no committed txn can be lost, but
  reads on the standby may still lag.
* ``+SyncRepl``   — commit waits for the standby's APPLIED ack
  (remote_apply): failover yields an identical, already-warm image.

Failover promotes the standby through the real recovery machinery
(``repro.wal.recovery``), and ``point_in_time`` restores base backup +
shipped log to any LSN.  See ``tests/test_replication.py`` for the
crash/torn-stream guarantees and ``benchmarks/bench_replication.py``
for the latency/lag curves.
"""

from repro_torch.replication.cluster import (ACK_FD, SHIP_FD,
                                             ReplicatedCluster)
from repro_torch.replication.frames import (Frame, FrameAssembler, FrameKind,
                                            chop, encode_frame)
from repro_torch.replication.sender import LogSender
from repro_torch.replication.standby import StandbyNode

__all__ = [
    "ACK_FD", "SHIP_FD", "ReplicatedCluster", "Frame", "FrameAssembler",
    "FrameKind", "chop", "encode_frame", "LogSender", "StandbyNode",
]
