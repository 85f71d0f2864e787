"""Ring-native paged KV cache — the paper's buffer manager applied to
long-context LLM serving.

HBM holds a fixed pool of KV pages; everything beyond it spills through
the ring to a two-tier backing store: a host-DRAM spill store
(``KV_HOST_FD``, microsecond latency) and an NVMe cold tier
(``KV_NVME_FD``, the paper's Table-1 SSD array).  The pager is a thin
policy layer over the REAL runtime — ``BufferPool`` fix/unfix with
clock-sweep replacement and batched dirty writeback (WAL-free), fibers
on a ``FiberScheduler``, and the same submit policies the storage
engine uses — so every §3 buffer-manager lesson applies verbatim to
paged-attention cache misses.

The serving ladder (``PagerConfig.ladder``) mirrors the engine's
EngineConfig ladder:

  sync            per-op submit, plain buffers, demand misses only
  +Batch          adaptive batched submission + batched eviction (§3.3.1/3)
  +RegBufs        registered frames: READ/WRITE_FIXED, no pin/copy (§3.4.1)
  +Prefetch(k)    per-sequence read-ahead fibers walk the block table k
                  blocks past the decode cursor and fault absent pages
                  with ONE batched submission (§3.3.3)
  +PassthruRead   cold-tier reads go NVMe passthrough (io_uring-cmd),
                  bypassing the generic storage stack (§3.4.1)

Pages are addressed by ``key = (seq, block)``; the pager assigns each
key a backing pid host-first, overflowing to the cold tier, and routes
I/O per pid through ``BufferPool.placement``.  The decode loop is the
miss-generator: each token walks the sequence's whole block table
(paged attention reads every page) and appends into the tail block.

Correctness anchor: ``device_pools()`` exposes the frame table as the
(k_pool, v_pool) tensors ``kernels/paged_attn`` consumes (on the card,
the paged CUDA kernel), and the paged-vs-unpaged equivalence under
forced thrashing is pinned in tests/test_torch_paging.py.

The port's copy of ``repro.serve.kv_paging``: the same code line for
line, over the port's copies of the runtime (``repro_torch.core``,
``bufferpool``, ``observe``), except the three page helpers, which use
torch with the same [K|V] bf16 frame layout byte for byte.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field, replace
from typing import Dict, Generator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.bufferpool import BufferPool, PoolConfig
from repro_torch.core import (AdaptiveBatcher, EagerSubmit, FiberScheduler,
                              Gate, IoUring, SetupFlags, Timeline)
from repro_torch.core.backends import (KV_HOST_FD, KV_NVME_FD, SimDisk,
                                       host_dram_spec, kv_nvme_spec)
from repro_torch.core.sqe import LatHist, RingStats
from repro_torch.observe import metrics as _metrics

Key = Tuple[int, int]            # (sequence id, block index)


@dataclass
class PagerConfig:
    # --- geometry -----------------------------------------------------
    n_hbm_pages: int = 64            # device pool size (frames)
    page_tokens: int = 32
    kv_heads: int = 2
    head_dim: int = 64
    n_layers: int = 1                # kept for API compat; pids span layers
    dtype: str = "bfloat16"
    host_pages: int = 256            # host-DRAM spill capacity (pages)
    nvme_pages: int = 4096           # NVMe cold-tier capacity (pages)
    # --- ladder knobs (PagerConfig.ladder builds the rungs) -----------
    name: str = "sync"
    batch: bool = False              # adaptive batched submission+eviction
    fixed_bufs: bool = False         # registered frames (READ/WRITE_FIXED)
    prefetch_k: int = 0              # read-ahead window (0 = off)
    passthru_read: bool = False      # cold-tier reads via io_uring-cmd
    evict_batch: int = 8
    #: modeled attention compute per (page, token) visit — what the
    #: prefetch fibers overlap I/O against
    decode_compute_s: float = 2e-7
    #: fault-injection plane (repro_torch.core.faults.FaultSpec); None
    #: or an all-zero spec leaves the tiers untouched.  The pool's recovery
    #: policy covers the pager wholesale: reads retry (passthru cold
    #: reads degrade to regular reads on ENOTSUP/timeout), failed spill
    #: writebacks keep the frame dirty and resident.
    faults: object = None

    @property
    def page_bytes(self) -> int:
        return 2 * self.page_tokens * self.kv_heads * self.head_dim * 2

    @staticmethod
    def ladder(*, prefetch_k: int = 8, **kw) -> List["PagerConfig"]:
        """The serving ladder, worst to best (paper §3 step-wise)."""
        def rung(name, **knobs):
            return PagerConfig(name=name, **knobs, **kw)
        return [
            rung("sync"),
            rung("+Batch", batch=True),
            rung("+RegBufs", batch=True, fixed_bufs=True),
            rung(f"+Prefetch({prefetch_k})", batch=True, fixed_bufs=True,
                 prefetch_k=prefetch_k),
            rung("+PassthruRead", batch=True, fixed_bufs=True,
                 prefetch_k=prefetch_k, passthru_read=True),
        ]


@dataclass
class SeqState:
    n_blocks: int                    # block-table length
    tail_fill: int                   # tokens in the last block
    cursor: int = 0                  # decode read position (block index)
    tokens_done: int = 0


class KVPager:
    """KV-cache pager over the buffer pool + ring runtime.

    Generator methods (``put_page``/``fix_page``/``read_page``/
    ``decode_step``) run inside fibers; the ``*_sync`` wrappers drive
    one fiber to completion for tests and examples.  Duck-type
    compatible with ``repro_torch.observe.slo.run_open_loop`` (``tl``,
    ``sched``, ``mc``, ``spawn_service_fibers``)."""

    def __init__(self, cfg: PagerConfig,
                 timeline: Optional[Timeline] = None):
        self.cfg = cfg
        self.tl = timeline or Timeline()
        self.page_bytes = cfg.page_bytes
        self.ring = IoUring(self.tl, sq_depth=512,
                            setup=SetupFlags.DEFER_TASKRUN |
                            SetupFlags.SINGLE_ISSUER)
        # two-tier backing store on named device slots
        self.host = SimDisk(self.tl, cfg.host_pages * self.page_bytes,
                            spec=host_dram_spec())
        self.cold = SimDisk(self.tl, cfg.nvme_pages * self.page_bytes,
                            spec=kv_nvme_spec())
        from repro_torch.core.faults import maybe_plane
        self.fault_plane = maybe_plane(cfg.faults)
        if self.fault_plane is not None:
            self.host.faults = self.fault_plane
            self.cold.faults = self.fault_plane
        self.ring.register_device(KV_HOST_FD, self.host)
        self.ring.register_device(KV_NVME_FD, self.cold)
        self.sched = FiberScheduler(
            ring=self.ring,
            policy=AdaptiveBatcher() if cfg.batch else EagerSubmit(),
            per_op_submit=not cfg.batch)
        self.pool = BufferPool(self.ring, PoolConfig(
            n_frames=cfg.n_hbm_pages, page_size=self.page_bytes,
            batch_evict=cfg.batch, evict_batch=cfg.evict_batch,
            fixed_bufs=cfg.fixed_bufs, passthrough=False, fd=KV_HOST_FD))
        self.pool.placement = self._placement
        # key -> backing pid, assigned host-first then cold
        self.key_pid: Dict[Key, int] = {}
        self._next_host = 0
        self._next_cold = 0
        self.seqs: Dict[int, SeqState] = {}
        # slo.run_open_loop duck-typing (single-core engine shape)
        self.mc = False
        self.n_cores = 1
        self._mreg = None
        self._t_last_token = 0.0
        # demand-triggered cleaner wakeup (see _cleaner)
        self._clean_low = max(2 * cfg.evict_batch, cfg.n_hbm_pages // 16)
        self._clean_gate: Optional[Gate] = None
        self._reset_counters()

    # ------------------------------------------------------- placement

    def _placement(self, pid: int):
        """Host pids [0, host_pages) live on the spill store; higher
        pids on the NVMe cold tier (passthrough when the rung says so —
        the cold tier is a raw namespace, the host store is not)."""
        hp = self.cfg.host_pages
        if pid < hp:
            return KV_HOST_FD, pid * self.page_bytes, False
        return (KV_NVME_FD, (pid - hp) * self.page_bytes,
                self.cfg.passthru_read)

    def _assign_pid(self, key: Key) -> int:
        pid = self.key_pid.get(key)
        if pid is None:
            if self._next_host < self.cfg.host_pages:
                pid = self._next_host
                self._next_host += 1
            else:
                pid = self.cfg.host_pages + self._next_cold
                self._next_cold += 1
                assert self._next_cold <= self.cfg.nvme_pages, \
                    "cold tier full"
            self.key_pid[key] = pid
        return pid

    def spilled_pages(self) -> int:
        """Pages with a backing pid that are not currently resident."""
        return len(self.key_pid) - len(self.pool.table)

    @property
    def faults(self) -> int:
        return self.pool.faults

    @property
    def hits(self) -> int:
        return self.pool.hits

    # --------------------------------------------------- page fix path

    def fix_page(self, key: Key) -> Generator:
        """``idx = yield from pager.fix_page(key)`` — pin the page's
        frame, faulting it from its tier on a miss.  Caller unfixes via
        ``pager.pool.unfix(idx, dirty=...)``."""
        pid = self.key_pid[key]
        self._maybe_wake_cleaner()
        idx0 = self.pool.table.get(pid)
        if idx0 is None or self.pool.meta[idx0].loading:
            # demand miss (a prefetch still in flight counts: the
            # decoder stalls either way, just for less time)
            self.demand_faults += 1
            if pid >= self.cfg.host_pages:
                self.cold_reads += 1
            else:
                self.host_reads += 1
            t0 = self.tl.now
            idx = yield from self.pool.fix(pid)
            self.demand_wait_s += self.tl.now - t0
            return idx
        return (yield from self.pool.fix(pid))

    def put_page(self, key: Key, data: bytes) -> Generator:
        """Install/overwrite one packed [K|V] page; dirty, unpinned."""
        assert len(data) == self.page_bytes
        if key in self.key_pid:
            idx = yield from self.fix_page(key)
        else:
            self._maybe_wake_cleaner()
            idx = yield from self.pool.fix_new(self._assign_pid(key))
        self.pool.page(idx)[:] = data
        self.pool.unfix(idx, dirty=True)

    def read_page(self, key: Key) -> Generator:
        idx = yield from self.fix_page(key)
        data = bytes(self.pool.page(idx))
        self.pool.unfix(idx)
        return data

    # -------------------------------------------------- decode fibers

    def _charge(self, seconds: float) -> None:
        self.tl.run_until(self.tl.now + seconds)

    def _append_token(self, seq: int, st: SeqState) -> Generator:
        """Write one decoded token's K/V into the tail block, growing
        the block table when the tail is full."""
        cfg = self.cfg
        if st.tail_fill >= cfg.page_tokens:
            st.n_blocks += 1
            st.tail_fill = 0
            key = (seq, st.n_blocks - 1)
            self._maybe_wake_cleaner()
            idx = yield from self.pool.fix_new(self._assign_pid(key))
        else:
            idx = yield from self.fix_page((seq, st.n_blocks - 1))
        # stamp a deterministic token record into the K half (the
        # refault property tests read these back byte-for-byte)
        off = st.tail_fill * cfg.kv_heads * cfg.head_dim * 2
        stamp = (seq * 1000003 + st.n_blocks * 1009 +
                 st.tail_fill) & 0xFFFFFFFF
        struct.pack_into("<I", self.pool.page(idx), off, stamp)
        self.pool.unfix(idx, dirty=True)
        st.tail_fill += 1
        st.tokens_done += 1
        self.tokens_done += 1
        self._t_last_token = self.tl.now

    def decode_step(self, seq: int, st: Optional[SeqState] = None
                    ) -> Generator:
        """One token of decode: paged attention touches EVERY block of
        the sequence (fix -> compute -> unfix, advancing the cursor the
        prefetch fibers chase), then the new token is appended."""
        if st is None:
            st = self.seqs[seq]
        t0 = self.tl.now
        for b in range(st.n_blocks):
            st.cursor = b
            idx = yield from self.fix_page((seq, b))
            self._charge(self.cfg.decode_compute_s)
            self.pool.unfix(idx)
            # use-once hint: this block is not needed again until the
            # NEXT token's walk, so make it the preferred victim —
            # otherwise read-behind pages (ref=True from the fix) crowd
            # the prefetch window out of the pool and read-ahead evicts
            # exactly the pages it just faulted in
            self.pool.meta[idx].ref = False
        yield from self._append_token(seq, st)
        self.token_lat.record(self.tl.now - t0)

    def prefetch_fiber(self, seq: int, stop) -> Generator:
        """Read-ahead: walk the block table up to ``prefetch_k`` blocks
        past the decode cursor (wrapping — the next token re-reads the
        whole table) and fault absent pages with one batched
        ``read_fixed`` submission.

        Two structural rules keep the pipeline full and stable:

        * a monotone *horizon* (absolute block position across token
          walks) is never re-issued — without it, a page evicted before
          the cursor arrives would be prefetched again and again, and
          the extra reads evict MORE not-yet-used pages: a feedback
          loop that doubles read traffic and erases the overlap win;
        * the watcher never blocks on its own batches — each top-up is
          spawned as a sub-fiber, so a batch in flight doesn't stall
          the next one and the decoder always has ~``prefetch_k``
          blocks of read-ahead in the pipe (waiting for the batch CQEs
          inline leaves a full device-latency bubble per batch, and the
          decoder demand-stalls on every cycle)."""
        k = self.cfg.prefetch_k
        trigger = max(1, k // 2)
        horizon = 0
        while not stop():
            st = self.seqs.get(seq)
            if st is None:
                yield None
                continue
            nb = st.n_blocks
            pos = st.tokens_done * nb + st.cursor   # monotone walk pos
            if horizon < pos:
                horizon = pos
            if horizon - pos < trigger:
                want = []
                for p in range(horizon + 1, pos + k + 1):
                    pid = self.key_pid.get((seq, p % nb))
                    if pid is not None and pid not in self.pool.table:
                        want.append(pid)
                horizon = pos + k
                if want:
                    self._maybe_wake_cleaner()
                    self.sched.spawn(self._prefetch_batch(want),
                                     name=f"kv-pf{seq}")
            yield None

    def _prefetch_batch(self, pids) -> Generator:
        n = yield from self.pool.prefetch_many(pids)
        self.prefetch_reads += n

    def _cleaner(self, stop) -> Generator:
        """Background writer (same policy as the storage engine's page
        cleaner): keep clean frames available so fresh-block allocation
        and prefetch never stall on synchronous writeback.

        Unlike the engine's cleaner this one PARKS on a gate when the
        free list is healthy, woken by the fix path (``_maybe_wake``):
        a cleaner spinning on bare yields keeps ``ready_count`` > 0
        forever, which defeats the adaptive batcher's flush-on-idle —
        every demand read would sit queued behind a busy-looking
        scheduler and the +Batch rung would LOSE latency instead of
        saving CPU."""
        pool = self.pool
        gate = self._clean_gate = Gate(self.sched)
        while not stop():
            if len(pool.free) < self._clean_low:
                n = yield from pool.evict_some()
                if n == 0:
                    yield None
            else:
                yield gate

    def _maybe_wake_cleaner(self) -> None:
        if (self._clean_gate is not None
                and len(self.pool.free) < self._clean_low):
            self._clean_gate.open()

    def spawn_service_fibers(self, workers, done) -> None:
        """Cleaner + per-sequence prefetch fibers (the background
        complement for both ``run_decode`` and the open-loop SLO
        harness)."""
        self.sched.spawn(self._cleaner(done), name="kv-cleaner")
        if self.cfg.prefetch_k > 0:
            for s in self.seqs:
                self.sched.spawn(self.prefetch_fiber(s, done),
                                 name=f"kv-prefetch{s}")

    # ------------------------------------------------------ workloads

    def prefill(self, n_seqs: int, n_blocks: int, seed: int = 0) -> None:
        """Install ``n_seqs`` sequences of ``n_blocks`` full-context KV
        pages (deterministic bytes per seed), then zero the stat
        surface so a following ``run_decode`` measures decode only."""
        rng = np.random.default_rng(seed)

        def filler():
            for s in range(n_seqs):
                self.seqs[s] = SeqState(n_blocks=n_blocks,
                                        tail_fill=self.cfg.page_tokens)
                for b in range(n_blocks):
                    data = rng.integers(0, 256, self.page_bytes,
                                        dtype=np.uint8).tobytes()
                    yield from self.put_page((s, b), data)

        f = self.sched.spawn(filler(), name="prefill")
        self.sched.run(until=lambda: f.done)
        self.reset_stats()

    def run_decode(self, *, n_tokens: int) -> dict:
        """Closed-loop decode: every prefilled sequence emits
        ``n_tokens`` tokens concurrently (one fiber each), prefetch and
        cleaner fibers riding along.  Returns the serving result row."""
        assert self.seqs, "prefill first"
        total = n_tokens * len(self.seqs)
        state = {"done": 0}

        def decoder(s, st):
            for _ in range(n_tokens):
                yield from self.decode_step(s, st)
                state["done"] += 1

        stop = lambda: state["done"] >= total           # noqa: E731
        mreg = _metrics.CURRENT
        if mreg is not None and self._mreg is not mreg:
            self._mreg = mreg
            self.register_metrics(mreg)
        t0 = self.tl.now
        self._t_last_token = t0
        for s, st in self.seqs.items():
            self.sched.spawn(decoder(s, st), name=f"decode{s}")
        self.spawn_service_fibers(None, stop)
        self.sched.run()
        return self.result(self._t_last_token - t0)

    def result(self, dt: float) -> dict:
        rs = self.ring.stats
        n_seqs = max(1, len(self.seqs))
        out = {
            "config": self.cfg.name,
            "tokens": self.tokens_done,
            "sim_seconds": dt,
            "tok_s": self.tokens_done / dt if dt > 0 else float("inf"),
            "faults": self.pool.faults,
            "hits": self.pool.hits,
            "demand_faults": self.demand_faults,
            "prefetch_reads": self.prefetch_reads,
            "host_reads": self.host_reads,
            "cold_reads": self.cold_reads,
            "writebacks": self.pool.writebacks,
            # advisor surface
            "pager_reads": self.pool.faults,
            "read_wait_frac": min(1.0, self.demand_wait_s /
                                  (dt * n_seqs)) if dt > 0 else 0.0,
            "prefetch_k": self.cfg.prefetch_k,
            "passthru_cmds": rs.passthru_cmds,
            # token latency (arrival-to-emit of decode_step)
            "p50_us": self.token_lat.p50() * 1e6,
            "p99_us": self.token_lat.p99() * 1e6,
            # ring surface
            "enters": rs.enters,
            "batch_eff": rs.batch_efficiency(),
            "worker_fallbacks": rs.worker_fallbacks,
            "bounce_mb": rs.bounce_bytes_copied / 1e6,
            "app_cpu_s": rs.cpu_seconds_app,
            "sqpoll_cpu_s": rs.cpu_seconds_sqpoll,
            "attribution": dict(rs.attribution),
        }
        if self.fault_plane is not None:
            out.update({
                "faults_injected": self.fault_plane.total_injected,
                "read_retries": self.pool.read_retries,
                "write_retries": self.pool.write_retries,
                "passthru_fallbacks": self.pool.passthru_fallbacks,
                "error_cqes": rs.error_cqes,
                "short_cqes": rs.short_cqes,
            })
        return out

    # ------------------------------------------------- stats & metrics

    def _reset_counters(self) -> None:
        self.demand_faults = 0
        self.demand_wait_s = 0.0
        self.prefetch_reads = 0
        self.host_reads = 0
        self.cold_reads = 0
        self.tokens_done = 0
        self.token_lat = LatHist()

    def reset_stats(self) -> None:
        """Zero the measurement surface (NOT page state).  Mutates the
        live ``RingStats`` in place so metric closures registered
        against it keep reading the same object."""
        self.ring.stats.__dict__.update(RingStats().__dict__)
        p = self.pool
        p.hits = p.faults = p.evictions = p.writebacks = p.wal_waits = 0
        p.read_retries = p.write_retries = p.passthru_fallbacks = 0
        self._reset_counters()

    def register_metrics(self, reg, prefix: str = "pager") -> None:
        """Pager stat surface for the telemetry sampler: the ring and
        pool surfaces plus decode-side counters.  Pure reads."""
        self.ring.register_metrics(reg, f"{prefix}/ring")
        self.pool.register_metrics(reg, f"{prefix}/pool")
        reg.counter(f"{prefix}/tokens", lambda: self.tokens_done)
        reg.wrate(f"{prefix}/tok_s", lambda: self.tokens_done,
                  unit="tok/s")
        reg.counter(f"{prefix}/demand_faults",
                    lambda: self.demand_faults)
        reg.counter(f"{prefix}/prefetch_reads",
                    lambda: self.prefetch_reads)
        reg.counter(f"{prefix}/cold_reads", lambda: self.cold_reads)
        reg.gauge(f"{prefix}/spilled_pages",
                  lambda: self.spilled_pages())

    # ---------------------------------------------- torch page helpers

    def pack_page(self, k_page, v_page) -> bytes:
        """(page_tokens, kv_heads, head_dim) K and V, tensors of any dtype
        on any device, cast to bf16 (round to nearest even) -> packed
        [K|V] frame bytes."""
        kv = torch.stack([torch.as_tensor(k_page).to(torch.bfloat16),
                          torch.as_tensor(v_page).to(torch.bfloat16)])
        return kv.cpu().contiguous().view(torch.int16).numpy().tobytes()

    def unpack_page(self, data) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        arr = np.frombuffer(bytes(data), np.uint8).view(np.int16)
        kv = torch.from_numpy(arr.copy()).view(torch.bfloat16).reshape(
            2, cfg.page_tokens, cfg.kv_heads, cfg.head_dim)
        return kv[0], kv[1]

    def device_pools(self, device="cuda") -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
        """The frame table as the (k_pool, v_pool) tensors
        ``kernels/paged_attn`` consumes — frame i is pool slot i; both
        are bf16 views of one (n_hbm_pages, 2, page_tokens, kv_heads,
        head_dim) tensor on ``device`` (the frames' bytes, uploaded in
        one copy). Raises without a card unless ``device="cpu"``."""
        cfg = self.cfg
        dev = resolve_device(device)
        raw = b"".join(bytes(f) for f in self.pool.frames)
        arr = np.frombuffer(raw, np.uint8).view(np.int16)
        kv = torch.from_numpy(arr.copy()).view(torch.bfloat16).reshape(
            cfg.n_hbm_pages, 2, cfg.page_tokens, cfg.kv_heads,
            cfg.head_dim).to(dev)
        return kv[:, 0], kv[:, 1]

    def slot_of(self, key: Key) -> int:
        """Resident frame index of a key (KeyError if spilled)."""
        return self.pool.table[self.key_pid[key]]

    # ------------------------------------------------- sync wrappers

    def run_sync(self, gen: Generator):
        f = self.sched.spawn(gen)
        self.sched.run(until=lambda: f.done)
        assert f.done
        return f.value

    def put_page_sync(self, key: Key, k_page, v_page) -> None:
        self.run_sync(self.put_page(key, self.pack_page(k_page, v_page)))

    def fix_page_sync(self, key: Key) -> int:
        """Pin + return the frame index; caller unfixes via
        ``pager.pool.unfix(idx)``."""
        return self.run_sync(self.fix_page(key))

    def read_page_sync(self, key: Key) -> bytes:
        return self.run_sync(self.read_page(key))
