"""Roofline terms of a dry-run trace (the port's copy of the jax-free
``repro/roofline/analysis.py``, with the H100's constants).

The collective traffic of a step is summed from its collectives' records
(``roofline.counters``: kind, bytes, group size and whether the group
crosses a node), converted to per-device *link traffic* with the
standard ring-algorithm formulas:

    all-gather          out_bytes × (n-1)/n
    reduce-scatter      out_bytes × (n-1)          (operand = out × n)
    all-reduce          2 × bytes × (n-1)/n        (RS + AG phases)
    all-to-all          bytes × (n-1)/n
    collective-permute  bytes

where n is the group size. A collective whose group stays inside one
node of ``launch.mesh.GPUS_PER_NODE`` cards moves over NVLink
(``NVLINK_BW``), any other between nodes (``INTERNODE_BW``, one
ConnectX-7 a GPU): data-sheet figures, not measurements. The JAX
package parses its records from compiled HLO (``parse_hlo_collectives``);
the port has no HLO, and its records come from the trace.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.launch.mesh import (HBM_BW, INTERNODE_BW, NVLINK_BW,
                                     PEAK_FLOPS_BF16)


def collective_bytes_moved(records: List[dict]) -> Tuple[float, Dict]:
    """Per-device link traffic (bytes) using ring formulas; returns
    (total, breakdown by kind). A record may say ``internode``: it is
    then also summed apart (``moved_internode``) for ``roofline_terms``."""
    by_kind: Dict[str, dict] = {}
    total = 0.0
    for r in records:
        n, b, k = max(2, r["group"]), r["bytes"], r["kind"]
        if k == "all-gather":
            moved = b * (n - 1) / n
        elif k == "reduce-scatter":
            moved = b * (n - 1)
        elif k == "all-reduce":
            moved = 2 * b * (n - 1) / n
        elif k == "all-to-all":
            moved = b * (n - 1) / n
        else:  # collective-permute
            moved = b
        total += moved
        agg = by_kind.setdefault(k, {"count": 0, "bytes": 0.0, "moved": 0.0,
                                     "moved_internode": 0.0})
        agg["count"] += 1
        agg["bytes"] += b
        agg["moved"] += moved
        if r.get("internode"):
            agg["moved_internode"] += moved
    return total, by_kind


def roofline_terms(*, hlo_flops: float, hlo_bytes: float,
                   coll_moved: float, n_chips: int,
                   coll_moved_internode: float = 0.0,
                   peak_flops: float = PEAK_FLOPS_BF16,
                   hbm_bw: float = HBM_BW, nvlink_bw: float = NVLINK_BW,
                   internode_bw: float = INTERNODE_BW,
                   flops_per_device: bool = True):
    """Three roofline terms in seconds (per step): the FLOPs over the
    card's bf16 peak, the bytes over its HBM rate, and the collective
    traffic inside a node over NVLink plus the traffic between nodes over
    the network (the names keep the JAX package's)."""
    if not flops_per_device:
        hlo_flops /= n_chips
        hlo_bytes /= n_chips
    t_comp = hlo_flops / peak_flops
    t_mem = hlo_bytes / hbm_bw
    t_coll = (coll_moved - coll_moved_internode) / nvlink_bw \
        + coll_moved_internode / internode_bw
    dom = max((t_comp, "compute"), (t_mem, "memory"), (t_coll, "collective"))
    return {
        "t_compute_s": t_comp,
        "t_memory_s": t_mem,
        "t_collective_s": t_coll,
        "bottleneck": dom[1],
        "t_bound_s": dom[0],
    }
