"""Render the roofline table of the port's dry run from
experiments/dryrun_torch/*.json (``python -m repro_torch.launch.dryrun
--all``). The twin of ``scripts/render_roofline.py``, with the H100's
bf16 peak (``repro_torch.launch.mesh``, a data-sheet figure) where that
script has the TPU's, and the traced peak against a card's 80 GB.

    PYTHONPATH=src python scripts/render_roofline_torch.py [dir]
"""

import glob
import json
import os
import sys

from repro_torch.launch.mesh import HBM_BYTES, PEAK_FLOPS_BF16


def rows_of(directory, mesh="16x16"):
    """(rows of the ok cells on ``mesh``, (arch, shape, why) of the
    skipped ones)."""
    rows, skips = [], []
    for fn in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(fn) as f:
            r = json.load(f)
        if "skipped" in r.get("status", ""):
            if r["mesh"] == mesh:
                skips.append((r["arch"], r["shape"], r["status"]))
            continue
        if r["mesh"] != mesh:
            continue
        t = r["roofline"]
        mf = r["model_flops_per_chip"]
        frac = mf / PEAK_FLOPS_BF16 / t["t_bound_s"] \
            if t["t_bound_s"] > 0 else 0.0
        rows.append({
            "arch": r["arch"], "shape": r["shape"], "kind": r["kind"],
            "tc": t["t_compute_s"], "tm": t["t_memory_s"],
            "tl": t["t_collective_s"], "b": t["bottleneck"],
            "frac": frac, "useful": r["useful_flops_frac"],
            "gb": r["memory"]["peak_est_bytes"] / 1e9,
        })
    return sorted(rows, key=lambda x: (x["arch"], x["shape"])), skips


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    directory = argv[0] if argv else "experiments/dryrun_torch"
    rows, skips = rows_of(directory)
    print("| arch | shape | compute s | memory s | collective s | bottleneck "
          "| roofline frac | useful FLOPs | peak GB (of 80) |")
    print("|---|---|---:|---:|---:|---|---:|---:|---:|")
    for r in rows:
        over = " **over**" if r["gb"] * 1e9 > HBM_BYTES else ""
        print(f"| {r['arch']} | {r['shape']} | {r['tc']:.3f} | {r['tm']:.3f} "
              f"| {r['tl']:.3f} | {r['b']} | {100*r['frac']:.1f}% "
              f"| {100*r['useful']:.0f}% | {r['gb']:.1f}{over} |")
    print()
    for a, s, why in skips:
        print(f"- `{a}` × `{s}`: **{why}**")


if __name__ == "__main__":
    main()
