"""Ring-based asynchronous input pipeline (paper GL2 applied to training
data): batched read submission into registered staging buffers, prefetch
depth > 1 so the accelerator never waits on storage, and hedged reads
(read + LINK_TIMEOUT + retry) for straggler mitigation on shared storage.

Uses the SAME ring runtime as the storage engine — the unified-interface
claim of the paper, exercised by the framework itself.

The port's copy of ``repro.data.pipeline`` (numpy only, on the port's
copy of the ring, ``repro_torch.core``): batches come out as numpy int32
arrays, and the train loop moves them to its device.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.core import (FileBackend, IoUring, SetupFlags, Timeline)
from repro_torch.core.ring import prep_link_timeout, prep_read_fixed
from repro_torch.core.sqe import SqeFlags


def make_synthetic_corpus(path: str, n_tokens: int, vocab: int,
                          seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, n_tokens, dtype=np.int32)
    with open(path, "wb") as f:
        toks.tofile(f)
    return path


class TokenStore:
    """A flat int32 token file."""

    def __init__(self, path: str):
        self.path = path
        self.n_tokens = os.path.getsize(path) // 4


class RingLoader:
    """Iterator of (batch, seq) int32 batches with ring-based prefetch.

    Batches are read with batched submission into registered buffers
    (one enter per prefetch group, zero-copy into the staging slab), then
    sliced into (tokens, labels).
    """

    def __init__(self, store: TokenStore, *, batch: int, seq: int,
                 prefetch: int = 4, hedge_timeout_s: Optional[float] = None,
                 seed: int = 0, timeline: Optional[Timeline] = None):
        self.store = store
        self.batch = batch
        self.seq = seq
        self.prefetch = prefetch
        self.hedge = hedge_timeout_s
        self.rng = np.random.default_rng(seed)
        self.tl = timeline or Timeline()
        self.ring = IoUring(self.tl, sq_depth=max(64, 2 * prefetch),
                            setup=SetupFlags.DEFER_TASKRUN |
                            SetupFlags.SINGLE_ISSUER)
        self.fb = FileBackend(store.path)
        self.ring.register_device(7, self.fb)
        self.slab_bytes = batch * (seq + 1) * 4
        self.slabs = [bytearray(self.slab_bytes) for _ in range(prefetch)]
        self.ring.register_buffers(self.slabs)
        self._inflight: Dict[int, int] = {}      # user_data -> slab idx
        self._ud = 1000
        self.hedged_reads = 0
        self.stats = self.ring.stats

    def _submit_one(self, slab_idx: int) -> None:
        """One batch = `batch` sequence reads of (seq+1) tokens, batched
        into a single submission."""
        row_bytes = (self.seq + 1) * 4
        max_start = self.store.n_tokens - (self.seq + 1)
        self._ud += 1
        ud = self._ud
        for b in range(self.batch):
            off = int(self.rng.integers(0, max_start)) * 4
            sqe = self.ring.get_sqe()
            while sqe is None:
                self.ring.submit()
                sqe = self.ring.get_sqe()
            prep_read_fixed(sqe, 7, slab_idx, off, row_bytes,
                            user_data=ud * 10_000 + b)
            sqe.buf = memoryview(self.slabs[slab_idx])[
                b * row_bytes:(b + 1) * row_bytes]
            sqe.buf_index = -1           # per-row view of the slab
            if self.hedge is not None:
                sqe.flags |= SqeFlags.IO_LINK
                tsqe = self.ring.get_sqe()
                prep_link_timeout(tsqe, self.hedge,
                                  user_data=ud * 10_000 + b)
        self.ring.submit()
        self._inflight[ud] = slab_idx

    def __iter__(self) -> Iterator[dict]:
        order = list(range(self.prefetch))
        for i in order:
            self._submit_one(i)
        while True:
            ud = min(self._inflight)
            slab_idx = self._inflight.pop(ud)
            need = self.batch
            got = 0
            while got < need:
                cqe = self.ring.wait_cqe()
                if cqe.user_data // 10_000 == ud:
                    got += 1
            arr = np.frombuffer(self.slabs[slab_idx], np.int32).reshape(
                self.batch, self.seq + 1).copy()
            self._submit_one(slab_idx)   # refill the slab
            yield {"tokens": arr[:, :-1], "labels": arr[:, 1:]}
