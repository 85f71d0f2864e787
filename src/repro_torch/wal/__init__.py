"""Write-ahead logging for the storage engine (paper §3.4.2 / Fig. 9).

The paper's durable-write analysis — write+fsync on the io_worker
fallback, linked write→fsync chains, and NVMe passthrough flush on
power-loss-protected (PLP) devices — was previously exercised only as a
micro-benchmark.  This package makes ``StorageEngine`` transactions
actually durable over the simulated NVMe array and recoverable after a
simulated crash, so the Fig. 9 trade-offs show up end-to-end in TPC-C.

Design (ARIES-lite, redo-only)
==============================

*Log* (``log.py``)
    An append-only log on a dedicated ``SimDisk`` fd.  Records are
    CRC-framed (begin/update/commit/abort/apply/checkpoint); the LSN of
    a record is its byte offset in the log.  Flushes write 4 KiB-aligned
    blocks, optionally from a registered (pinned) staging buffer.

*Group commit* (``group_commit.py``)
    Concurrent fibers' commit requests are batched by a coordinator:
    the first committer becomes the leader and flushes everything
    appended so far with ONE linked write→fsync SQE chain
    (``SqeFlags.IO_LINK``); followers suspend until ``durable_lsn``
    covers their commit record.  Three flush paths map onto Fig. 9:

      ``fsync``     write, wait, fsync — two submissions; the fsync
                    takes the io_worker fallback (+7.3 µs)
      ``linked``    write→fsync chained with IO_LINK, one submission
      ``passthru``  passthrough write + NVMe flush on a PLP device
                    (``prep_fsync(nvme_flush=True)``) — flush completes
                    on the poll set in ~5 µs

*Durability ladder* (``storage/engine.py``)
    ``EngineConfig(durability=...)`` extends the paper's Fig. 5 ladder:

      +WAL          per-txn commit: each committer flushes its own
                    records (write+fsync path)
      +GroupCommit  group-commit coordinator, linked write→fsync
      +PassthruFlush  group commit over a passthrough log device with
                    NVMe flush (enterprise/PLP)

*Transactions* are redo-only with deferred application: a txn streams
UPDATE/INSERT intent records into the log buffer while it runs, buffers
its write-set in memory, and only after its COMMIT record is durable
applies the write-set to the B-tree.  An uncommitted txn therefore
never touches the tree — no undo pass is needed and no aborted txn can
leak to disk.  Each application is logged as one atomic APPLY record
(physiological page deltas for plain leaf upserts, full page images for
pages touched by a split) whose CRC makes it all-or-nothing.

*WAL-before-data*: every page carries its last APPLY LSN in the page
header (``btree.PAGE_LSN_OFF``); the buffer pool refuses to write back
a dirty page until the log is durable up to that LSN
(``BufferPool.evict_some`` → ``wal.flush_to``).  A background page
cleaner (``StorageEngine.page_cleaner``) keeps clean frames available
for splits when the working set is fully resident.

*Recovery* (``recovery.py``)
    ``recover(data_image, log_image)`` rebuilds an engine from the
    crashed images: an analysis pass scans the whole log (winners =
    txns with a COMMIT record, losers ignored); a redo pass replays
    APPLY records in LSN order guarded by each page's LSN; a logical
    pass re-runs the intents of committed txns whose APPLY record never
    became durable (idempotent upserts).  Fuzzy CHECKPOINT records
    carry the root/next_pid and the dirty-page table so redo can skip
    clean history.

Usage::

    cfg = EngineConfig("+GroupCommit", durability="group")
    eng = StorageEngine(cfg, n_tuples=100_000)
    def txn(rng):
        t = eng.begin()
        yield from t.update(key, value)
        yield from eng.commit(t)       # suspends until LSN durable
    eng.run_fibers(txn, n_txns)
    data, log = eng.crash_images()     # simulate power loss
    rec, report = recover(data, log)   # committed txns visible again
"""

from repro_torch.wal.group_commit import GroupCommit
from repro_torch.wal.log import (LogRecord, RecordType, WalStats,
                                 WriteAheadLog, scan_log)
from repro_torch.wal.recovery import RecoveryReport, recover

__all__ = [
    "GroupCommit", "LogRecord", "RecordType", "RecoveryReport",
    "WalStats", "WriteAheadLog", "recover", "scan_log",
]
