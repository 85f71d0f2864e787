"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
also ``breakdown``, and last ``checks``: each number compared with its
limit). The same numbers and limits are the last lines of standard error.
Without a CUDA card, with fewer cards than the cell asks for, or if JAX or
the JAX package was loaded, it prints no result and exits non-zero.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import json
    import torch
    from bench import harness

    cell = harness.Cell(ROOT / "BENCHMARK.json", args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.w["chips"]:
        print(f"needs {cell.w['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run_cell(ROOT / "BENCHMARK.json", args.workload,
                           args.seed, args.seconds, bool(args.trace),
                           t_start=T_START)
    found = sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)
    if found:
        print(f"refused: the run loaded {found}", file=sys.stderr)
        return 3
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
