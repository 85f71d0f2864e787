"""Read the numbers that ``correct`` compares, over many seeds in one
process, to set a cell's limits (``limits/<cell>.json``) from readings.

    python3 bench/calibrate.py --workload <name> --seeds 1,2,3 \\
        --control-seeds 1,2,3 --seconds <s> --out <file.jsonl>

Each seed runs the cell as the command does, with a short window at the
cell's own load, and reads the program against the reference; on the
control seeds it also reads the control (the reference computed in fp8 in
the program's place) and, in training, the reference with half of each
batch left out. One JSON line a seed goes to ``--out``; a summary (the
largest program reading and the smallest control reading of each number)
to standard output. Not part of a benchmark run.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    from bench import harness
    seeds = [int(s) for s in a.seeds.split(",")]
    ctl = {int(s) for s in a.control_seeds.split(",") if s}
    worst, least = {}, {}
    with open(a.out, "a") as f:
        for seed in seeds:
            t0 = time.time()
            out = harness.run_cell(ROOT / "BENCHMARK.json", a.workload, seed,
                                   a.seconds, False, calibrate=seed in ctl)
            rd = out.pop("readings") if "readings" in out else {}
            line = {"seed": seed, "correct": out["correct"],
                    "checks": out["checks"], "readings": rd,
                    "metrics": out["metrics"], "device": out["device"],
                    "wall_s": time.time() - t0}
            f.write(json.dumps(line) + "\n")
            f.flush()
            for side, nums in rd.items():
                for k, v in nums.items():
                    if side == "program":
                        worst[k] = max(worst.get(k, v), v)
                    else:
                        least.setdefault(side, {})
                        least[side][k] = min(least[side].get(k, v), v)
            print(json.dumps({"seed": seed, "readings": rd}), flush=True)
    print(json.dumps({"workload": a.workload, "program_max": worst,
                      "others_min": least}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
