"""Shared morsel/chunk plan for the shuffle (engine AND oracle).

One worker's data movement is a pure function of the config: scan the
assigned slice morsel by morsel, keep the local fraction for the probe
table, accumulate the remote remainder into one staging buffer per
destination, and flush a ``chunk_bytes`` send whenever a buffer fills
(residuals at end-of-scan).  Both the ring-driven engine
(``shuffle.engine``) and the analytical oracle (``shuffle.sim``) iterate
this exact plan, so their byte movement is identical and any egress
disagreement is purely a *timing-model* delta — which is what the
cross-validation in ``benchmarks/bench_shuffle.py`` measures.

Destination staging also explains the engine's submission batching: all
n-1 buffers fill at the same rate, so flushes cluster into one
``io_uring_enter`` of ~(n_nodes - 1) sends (no hand-amortized syscall
constants anywhere).
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

Morsel = Tuple[str, int, int, int]      # ("morsel", nbytes, n_tuples, local)
Send = Tuple[str, int, int]             # ("send", dst, nbytes)


def worker_slice(cfg, worker: int) -> int:
    """Bytes scanned by one worker (last worker takes the remainder)."""
    per = cfg.total_bytes_per_node // cfg.n_workers
    if worker == cfg.n_workers - 1:
        per += cfg.total_bytes_per_node - per * cfg.n_workers
    return per


def morsel_plan(cfg, src: int, worker: int) -> Iterator:
    """Yield ("morsel", nbytes, n_tuples, local_bytes) for each scanned
    morsel, interleaved with ("send", dst, nbytes) chunk flushes."""
    n = cfg.n_nodes
    others: List[int] = [d for d in range(n) if d != src]
    rot = (worker + src) % len(others)     # stagger flows across dsts
    others = others[rot:] + others[:rot]
    acc = {d: 0 for d in others}
    remaining = worker_slice(cfg, worker)
    morsel = cfg.chunk_bytes               # scan granularity
    while remaining > 0:
        nb = min(morsel, remaining)
        remaining -= nb
        local = nb // n
        yield ("morsel", nb, nb // cfg.tuple_size, local)
        remote = nb - local
        share, rem = divmod(remote, len(others))
        for i, d in enumerate(others):
            acc[d] += share + (1 if i < rem else 0)
            if acc[d] >= cfg.chunk_bytes:
                yield ("send", d, acc[d])
                acc[d] = 0
    for d in others:                       # end of scan: flush residuals
        if acc[d]:
            yield ("send", d, acc[d])


def receiver_worker(cfg, dst: int, src: int) -> int:
    """Which of ``dst``'s worker cores services the flow from ``src``.
    Flows are spread round-robin over the node's workers; engine and
    oracle share this mapping so rx-side contention matches."""
    others = [p for p in range(cfg.n_nodes) if p != dst]
    return others.index(src) % cfg.n_workers


def expected_flow_bytes(cfg) -> dict:
    """{(src, dst): total bytes} over the whole shuffle — receivers use
    this to know when a flow is drained (deterministic termination)."""
    out = {}
    for src in range(cfg.n_nodes):
        for w in range(cfg.n_workers):
            for ev in morsel_plan(cfg, src, w):
                if ev[0] == "send":
                    _, dst, nb = ev
                    out[(src, dst)] = out.get((src, dst), 0) + nb
    return out
