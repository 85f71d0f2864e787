"""The traced run's reduction: ``torch.profiler`` over the traced window,
read from the profiler's raw events (no event tree is built, so a trace
of a million kernels reduces in seconds), and what the per-layer metrics
read from it.

* device intervals: every kernel, copy and set on the card (the ranges'
  own device marks left out); ``busy_s`` is the length of their union,
  ``window_s`` the traced window's host time;
* each kernel is attributed to the host operator that launched it (the
  profiler's correlation), and so to every host range that operator ran
  in, on its thread: ``range_s(name)`` is the device time of the kernels
  launched inside the ``record_function`` range ``name`` (the program's
  spans, of every prefix in ``repro_torch.observe.spans.PREFIXES``:
  ``moe_dispatch``, ``optim_adamw``, ...), ``op_s(op)`` of those launched
  inside the operator ``op`` (``repro_torch::flash_fwd``, ...);
* the decode phase of a generate (the harness's ``bench.unit`` range
  around each call): what is launched after its first ``aten::argmax``,
  the prefill's pick of the first token; ``decode_launches()`` counts
  the host's launch calls there (``cudaLaunchKernel*``, ``cuLaunchKernel*``,
  and a CUDA graph's ``cudaGraphLaunch`` once, however many kernels it
  replays);
* the breakdown: the device operations that took most time, and the
  longest idle gaps of the card, each named by the innermost host
  operator running when it began.
"""

from __future__ import annotations

import bisect
import contextlib
import sys
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

UNIT = "bench.unit"
PICK = "aten::argmax"
# the runtime's and the driver's calls that each put work on the card
LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel",
          "cuLaunchCooperativeKernel", "cudaGraphLaunch", "cuGraphLaunch")


@contextlib.contextmanager
def profiling(on: bool):
    if not on:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()


def unit_range():
    from torch.profiler import record_function
    return record_function(UNIT)


def _union(iv) -> float:
    total, end = 0.0, -np.inf
    for a, b in sorted(iv):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


class _Spans:
    """Host intervals of one name, per thread, for point lookups."""

    def __init__(self):
        self.by_thread: Dict[int, List[Tuple[int, int]]] = {}

    def add(self, a, b, tid):
        self.by_thread.setdefault(tid, []).append((a, b))

    def done(self):
        for v in self.by_thread.values():
            v.sort()
        self.starts = {t: [a for a, _ in v] for t, v in self.by_thread.items()}
        return self

    def holds(self, t, tid) -> bool:
        v = self.by_thread.get(tid)
        if not v:
            return False
        i = bisect.bisect_right(self.starts[tid], t) - 1
        return i >= 0 and v[i][1] >= t


def digest(prof, window_s: float) -> SimpleNamespace:
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
    return reduce(cpu, dev, window_s)


def reduce(cpu, dev, window_s: float) -> SimpleNamespace:
    """The digest of a trace's events: ``cpu`` as (start_ns, end_ns, name,
    correlation, thread), host operators, ranges and the runtime's calls;
    ``dev`` as (start_ns, end_ns, name, correlation of the launching
    call), what ran on the card."""
    marks = {n for _, _, n, _, _ in cpu if n == UNIT or n.startswith("moe_")}
    dev = [d for d in dev if d[2] not in marks]
    dev.sort()
    launch = {c: (a, tid) for a, _, _, c, tid in cpu if c}
    # the program's spans of every prefix it names, read at run time, so a
    # span under a new prefix is a range without an edit here
    from repro_torch.observe.spans import PREFIXES
    ranges = ("moe_", "repro_torch::") + tuple(PREFIXES)
    spans: Dict[str, _Spans] = {}
    for a, b, n, _, tid in cpu:
        if n == UNIT or n.startswith(ranges):
            spans.setdefault(n, _Spans()).add(a, b, tid)
    for s in spans.values():
        s.done()
    picks = sorted(a for a, _, n, _, _ in cpu if n == PICK)
    units = sorted((a, b) for a, b, n, _, _ in cpu if n == UNIT)
    decode_from = []              # per unit: host time its decode begins
    for a, b in units:
        i = bisect.bisect_left(picks, a)
        decode_from.append(picks[i] if i < len(picks) and picks[i] <= b
                           else None)
    unit_starts = [a for a, _ in units]

    def in_decode(t):
        i = bisect.bisect_right(unit_starts, t) - 1
        return i >= 0 and t <= units[i][1] and decode_from[i] is not None \
            and t > decode_from[i]

    # each kernel with the host time and thread of its launching operator
    kern = [(a, b, n, launch.get(c)) for a, b, n, c in dev]
    found = sum(1 for k in kern if k[3] is not None)
    print(f"trace: {len(kern)} device operations, {found} attributed to "
          f"the host operator that launched them", file=sys.stderr)

    def under(name: str, phase: Optional[str] = None) -> Optional[float]:
        s = spans.get(name)
        if s is None:
            return None
        tot, seen = 0, False
        for a, b, _, at in kern:
            if at is None or not s.holds(at[0], at[1]):
                continue
            if phase == "decode" and not in_decode(at[0]):
                continue
            tot, seen = tot + b - a, True
        return tot * 1e-9 if seen else None

    calls: Dict[str, int] = {}
    for a, _, n, _, _ in cpu:
        if n.startswith(LAUNCH) and in_decode(a):
            calls[n] = calls.get(n, 0) + 1
    print(f"trace: launch calls in the decode phases {calls}",
          file=sys.stderr)

    def decode_launches() -> Optional[int]:
        return sum(calls.values()) or None

    by_name: Dict[str, float] = {}
    for a, b, n, _ in kern:
        by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-9
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    gaps, end = [], None
    for a, b, _, _ in kern:
        if end is not None and a > end:
            gaps.append((a - end, end))
        end = b if end is None else max(end, b)
    gaps.sort(reverse=True)
    host = [(a, b, n) for a, b, n, _, _ in cpu
            if not n.startswith(("cuda", "cu", "Activity"))]
    hs = np.array([h[0] for h in host], dtype=np.int64)
    he = np.array([h[1] for h in host], dtype=np.int64)
    idle = []
    for g, t0 in gaps[:10]:
        live = np.nonzero((hs <= t0) & (he >= t0))[0]
        name = host[live[np.argmax(hs[live])]][2] if live.size else "(none)"
        idle.append([name, g * 1e-9])
    busy = _union([(a, b) for a, b, _, _ in kern]) * 1e-9
    return SimpleNamespace(
        busy_s=busy, window_s=window_s,
        range_s=under, op_s=lambda op: under(op) or 0.0,
        decode_launches=decode_launches,
        breakdown={"device_ops": [[n, s] for n, s in device_ops],
                   "idle_gaps": idle})
