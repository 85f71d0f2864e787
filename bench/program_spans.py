"""The program's spans and counters (``repro_torch.observe.spans``) read
for the benchmark, and a pass that reads them in one cell.

From a profile (raw events as ``tracing.reduce`` takes them: host
``(start_ns, end_ns, name, correlation, thread)``, device ``(start_ns,
end_ns, name, correlation of the launching call)``, all on the profiler's
one clock):

* ``kernel_s_under(cpu, dev, name)``: device seconds of the kernels
  launched inside the host span ``name`` (as ``tracing``'s ``range_s``,
  for the program's spans of every prefix);
* ``idle_under(cpu, dev, name)``: the card's idle time inside the span's
  host intervals;
* ``idle_by_span(cpu, dev)``: the idle time between the profile's first
  and last event, split by the innermost program span open at each
  moment (``(none)`` outside every span).

From a recorder pass (``spans.take()``): ``decode_gaps`` (the
device-clock gaps between a generate's consecutive step exits, the first
from the prefill's exit), ``prefill_ms``, ``dropped_slot_share``.

``run`` times one cell's first ``trace_units`` units after the cell's
warm-up: ``ROUNDS`` pairs of a pass without the profiler and the
recorder and a pass with the recorder on, then a pass under the profiler
with the recorder off. It returns the per-layer readings, what the
recorder costs (the recorder passes' walls over the untraced ones) and
how the marks agree with the walls. On the card::

    python3 bench/program_spans.py --workload <cell> --seed <n>

prints the readings to standard error and the result object as the last
line of standard output.
"""

from __future__ import annotations

import argparse
import bisect
import heapq
import json
import os
import pathlib
import shutil
import statistics
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

ROOT = pathlib.Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench import harness, tracing, traffic  # noqa: E402
from bench import weights as W  # noqa: E402
from repro_torch.observe import spans  # noqa: E402

NONE = "(none)"
# pairs of untraced and recorder passes: a decode generate's wall moves
# by several % from one call to the next with the host's speed
ROUNDS = 3


def is_span(name: str) -> bool:
    return name.startswith(spans.PREFIXES)


# ---------------------------------------------------------------------------
# a profile's events
# ---------------------------------------------------------------------------

def without_marks(cpu, dev):
    """``dev`` without the device marks of the host ranges (the program's
    spans and the harness's unit range): what ran on the card."""
    ranges = {n for _, _, n, _, _ in cpu if n == tracing.UNIT or is_span(n)}
    return [d for d in dev if d[2] not in ranges]


def events(prof) -> Tuple[list, list]:
    """(cpu, dev) of a profile, as ``tracing.digest`` reads them."""
    CPU = torch.autograd.DeviceType.CPU
    cpu, dev = [], []
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == CPU:
            cpu.append((a, b, e.name(), e.correlation_id(),
                        e.start_thread_id()))
        elif not e.is_user_annotation():
            dev.append((a, b, e.name(), e.linked_correlation_id()))
    return cpu, without_marks(cpu, dev)


def _merged(iv) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class _Cover:
    """Sorted disjoint intervals, for the length they cover of [a, b]."""

    def __init__(self, iv):
        self.iv = _merged(iv)
        self.starts = [a for a, _ in self.iv]
        self.cum = np.concatenate([[0], np.cumsum(
            [b - a for a, b in self.iv])]).astype(np.int64)

    def within(self, a: int, b: int) -> int:
        if b <= a or not self.iv:
            return 0
        i = max(bisect.bisect_right(self.starts, a) - 1, 0)
        j = bisect.bisect_left(self.starts, b)
        if i >= j:
            return 0
        tot = int(self.cum[j] - self.cum[i])
        tot -= max(0, min(a, self.iv[i][1]) - self.iv[i][0])
        tot -= max(0, self.iv[j - 1][1] - max(b, self.iv[j - 1][0]))
        return tot


def kernel_s_under(cpu, dev, name: str) -> Optional[float]:
    """Device seconds of the kernels launched inside the host span
    ``name`` (on the launching thread); None when none was."""
    s = tracing._Spans()
    for a, b, n, _, tid in cpu:
        if n == name:
            s.add(a, b, tid)
    s.done()
    launch = {c: (a, tid) for a, _, _, c, tid in cpu if c}
    tot, seen = 0, False
    for a, b, _, c in dev:
        at = launch.get(c)
        if at is not None and s.holds(*at):
            tot, seen = tot + b - a, True
    return tot * 1e-9 if seen else None


def idle_under(cpu, dev, name: str) -> Optional[float]:
    """Seconds the card is idle inside the host intervals of ``name``;
    None when the profile has no such span."""
    iv = _merged([(a, b) for a, b, n, _, _ in cpu if n == name])
    if not iv:
        return None
    busy = _Cover([(a, b) for a, b, _, _ in dev])
    return sum((b - a) - busy.within(a, b) for a, b in iv) * 1e-9


def _innermost(cpu) -> List[Tuple[int, int, str]]:
    """The timeline of the innermost program span, across threads: the
    span that began last among those open, as (start, end, name)
    segments; times outside every span are left out."""
    iv = sorted((a, b, n) for a, b, n, _, _ in cpu if is_span(n) and b > a)
    cuts = sorted({t for a, b, _ in iv for t in (a, b)})
    out, heap, k = [], [], 0
    for t0, t1 in zip(cuts, cuts[1:]):
        while k < len(iv) and iv[k][0] <= t0:
            a, b, n = iv[k]
            heapq.heappush(heap, (-a, b, n))
            k += 1
        while heap and heap[0][1] <= t0:
            heapq.heappop(heap)
        if not heap:
            continue
        # the latest start among the open spans (an ended one deeper in
        # the heap is dropped when it comes to the top)
        n = heap[0][2]
        if out and out[-1][1] == t0 and out[-1][2] == n:
            out[-1] = (out[-1][0], t1, n)
        else:
            out.append((t0, t1, n))
    return out


def idle_by_span(cpu, dev) -> Dict[str, float]:
    """The card's idle seconds from the profile's first event to its
    last, by the innermost program span open at each moment."""
    if not cpu and not dev:
        return {}
    t0 = min([e[0] for e in cpu] + [d[0] for d in dev])
    t1 = max([e[1] for e in cpu] + [d[1] for d in dev])
    gaps, end = [], t0
    for a, b in _merged([(a, b) for a, b, _, _ in dev]):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if t1 > end:
        gaps.append((end, t1))
    segs = _innermost(cpu)
    out: Dict[str, float] = {}
    i = 0
    for g0, g1 in gaps:
        covered = 0
        while i < len(segs) and segs[i][1] <= g0:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < g1:
            a, b, n = segs[j]
            d = min(b, g1) - max(a, g0)
            if d > 0:
                out[n] = out.get(n, 0.0) + d * 1e-9
                covered += d
            j += 1
        if g1 - g0 > covered:
            out[NONE] = out.get(NONE, 0.0) + (g1 - g0 - covered) * 1e-9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


# ---------------------------------------------------------------------------
# a recorder pass's records
# ---------------------------------------------------------------------------

def generates(records) -> List[Tuple[spans.Record, List[spans.Record]]]:
    """Each ``serve_generate``'s prefill record and decode records."""
    pre: Dict[int, spans.Record] = {}
    dec: Dict[int, List[spans.Record]] = {}
    for r in records:
        if r.name == "serve_prefill":
            pre[r.parent] = r
        elif r.name == "serve_decode":
            dec.setdefault(r.parent, []).append(r)
    return [(pre[i], dec.get(i, [])) for i, r in enumerate(records)
            if r.name == "serve_generate" and i in pre]


def decode_gaps(records) -> List[List[float]]:
    """Per generate, the device-clock ms between consecutive step exits,
    the first from the prefill's exit."""
    out = []
    for p, ds in generates(records):
        ends = [p.mark1_ms] + [d.mark1_ms for d in ds]
        out.append([b - a for a, b in zip(ends, ends[1:])])
    return out


def prefill_ms(records) -> Optional[float]:
    """The mean of the prefills' entry-to-exit marks, a generate."""
    ps = [p.mark1_ms - p.mark0_ms for p, _ in generates(records)]
    return statistics.fmean(ps) if ps else None


def dropped_slot_share(counters) -> Optional[float]:
    """Slots dropped at capacity, in % of all the dispatches' slots."""
    slots = counters.get("moe_slots", 0)
    if not slots:
        return None
    return 100.0 * (1.0 - counters.get("moe_kept_slots", 0) / slots)


# ---------------------------------------------------------------------------
# the three passes over one cell
# ---------------------------------------------------------------------------

def _serve_units(cell, seed, dev):
    from repro_torch.models import lm
    from repro_torch.serve import ServeLoop
    m, t = cell.m, cell.traffic
    pc = harness.port_config(m, cell.w["config"], train=False)
    tree = W.make_tree(cell.leaves, seed, dev, pc.compute_dt())
    harness.check_layout(tree, lm.abstract_params(pc))
    ls = traffic.lengths(t)
    loop = ServeLoop(pc, tree, max_len=max(ls) + t["n_new"], device=dev)
    del tree
    V = m["vocab_size"]
    warm = np.random.default_rng([seed, 3]).integers(
        0, V, (t["batch"], max(ls)), dtype=np.int32)
    loop.generate(warm, t["n_new"]).cpu()
    units = [traffic.unit(t, seed, i, V) for i in range(t["trace_units"])]

    def one(u):
        return loop.generate(u["tokens"], u["n_new"]).cpu()
    return units, one, lambda: None


def _train_units(cell, seed, dev):
    from repro_torch.data.pipeline import RingLoader, TokenStore
    from repro_torch.train.loop import TrainLoop, TrainLoopConfig
    m, t = cell.m, cell.traffic
    o = t["optimizer"]
    pc = harness.port_config(m, cell.w["config"], train=True)
    tmp = tempfile.mkdtemp(prefix="bench-spans-")
    path = os.path.join(tmp, "corpus.bin")
    traffic.corpus(t, seed, m["vocab_size"]).tofile(path)
    loader = RingLoader(TokenStore(path), batch=t["batch"], seq=t["seq"],
                        prefetch=4, seed=seed)
    loop = TrainLoop(pc, TrainLoopConfig(
        total_steps=o["total"], ckpt_every=1 << 62,
        ckpt_dir=os.path.join(tmp, "ckpt"), log_every=1 << 62,
        peak_lr=o["peak_lr"]), iter(loader),
        params=W.make_tree(cell.leaves, seed, dev, torch.float32), device=dev)
    n, state = t["chunk_steps"], {"step": 0}

    def one(_):
        loop.start_step = state["step"]
        loop.lc.total_steps = state["step"] + n
        loop.run()
        state["step"] += n
        if dev.type == "cuda":
            torch.cuda.synchronize()
    one(None)                                    # warm-up
    return [{"steps": n}] * t["trace_units"], one, \
        lambda: shutil.rmtree(tmp, ignore_errors=True)


def run(spec_path, workload: str, seed: int, *, device="cuda",
        data_root=None) -> dict:
    """The passes over ``workload``'s traced units: ``ROUNDS`` pairs of an
    untraced pass and a recorder pass, in turn (the readings come from the
    first recorder pass, the cost from all), then a profiled pass."""
    cell = harness.Cell(spec_path, workload, data_root)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    kind = cell.traffic["kind"]
    units, one, done = (_serve_units if kind == "serve" else
                        _train_units)(cell, int(seed), dev)
    try:
        def walls():
            out = []
            for u in units:
                ts = time.perf_counter()
                one(u)
                out.append(time.perf_counter() - ts)
            return out

        plain, recorded, taken = [], [], []
        for _ in range(ROUNDS):
            plain.append(walls())
            spans.enable()
            try:
                recorded.append(walls())
                taken.append(spans.take())
            finally:
                spans.disable()
        with tracing.profiling(True) as prof:
            profiled = walls()
        cpu, kern = events(prof)
    finally:
        done()
    records, counters = taken[0]
    out = {"workload": workload, "seed": int(seed), "kind": kind,
           "units": len(units), "walls_plain_s": plain,
           "walls_recorded_s": recorded, "walls_profiled_s": profiled,
           "recorder_cost": sum(map(sum, recorded)) / sum(map(sum, plain)),
           "recorder_cost_by_round": [sum(r) / sum(p) for p, r in
                                      zip(plain, recorded)],
           "counters": counters, "metrics": {}}
    busy = tracing._union([(a, b) for a, b, _, _ in kern]) * 1e-9
    out["busy_s"] = busy
    out["idle_by_span_s"] = idle_by_span(cpu, kern)
    share = dropped_slot_share(counters)
    met = out["metrics"]
    if kind == "train":
        steps = sum(u["steps"] for u in units)
        if share is not None:
            met["dropped_slot_share.train"] = share
        opt = kernel_s_under(cpu, kern, "optim_adamw")
        if opt is not None:
            met["optimizer_ms.train"] = 1e3 * opt / steps
        wait = idle_under(cpu, kern, "train_data")
        if wait is not None:
            met["loader_wait_ms.train"] = 1e3 * wait / steps
        out["busy_ms_a_step"] = 1e3 * busy / steps
        host: Dict[str, List[float]] = {}
        for r in records:
            if r.name in ("train_step", "train_data", "optim_adamw"):
                host.setdefault(r.name, []).append(
                    (r.t1_ns - r.t0_ns) * 1e-6)
        out["host_ms_a_step"] = {k: statistics.fmean(v)
                                 for k, v in host.items()}
        return out
    if cell.traffic["n_new"] == 1:
        if share is not None:
            met["dropped_slot_share.prefill"] = share
        return out
    gaps = decode_gaps(records)
    pooled = [g for gs in gaps for g in gs]
    pre = prefill_ms(records)
    if pooled:
        met["decode_step_ms.decode"] = statistics.median(pooled)
        out["decode_step_ms_p95"] = float(np.percentile(pooled, 95))
    if pre is not None:
        met["prefill_ms.decode"] = pre
    if share is not None:
        out["dropped_slot_share.decode"] = share
    # the marks against the walls: a generate's prefill and step gaps
    # over its wall in the recorder pass
    out["marks_over_walls"] = [
        ((p.mark1_ms - p.mark0_ms) + sum(g)) / (1e3 * w)
        for (p, _), g, w in zip(generates(records), gaps, recorded[0])]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args()
    out = run(ROOT / "BENCHMARK.json", args.workload, args.seed)
    log = sys.stderr
    for k, v in out["metrics"].items():
        print(f"{k} {v}", file=log)
    if "decode_step_ms_p95" in out:
        print(f"decode_step_ms p95 {out['decode_step_ms_p95']}", file=log)
    print(f"recorder pass walls over untraced walls {out['recorder_cost']}"
          f" (by round {out['recorder_cost_by_round']})", file=log)
    idle = sum(out["idle_by_span_s"].values()) or 1.0
    for k, v in out["idle_by_span_s"].items():
        print(f"idle under {k}: {v:.6f} s ({100 * v / idle:.1f}% of the "
              f"profiled pass's idle)", file=log)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
