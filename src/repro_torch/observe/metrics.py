"""Opt-in virtual-clock time-series telemetry (the metrics sampler).

Where ``repro.observe.trace`` records *events*, this module records
*state over time*: an installed ``MetricsRegistry`` is sampled at a
fixed virtual-time cadence while any ``FiberScheduler`` runs, producing
one ``(t, value)`` series per registered counter/gauge — ring enters
and batch efficiency, buffer-pool hit rate, WAL commit-queue depth,
replication apply lag, shuffle bytes moved — plus windowed percentile
digests (p50/p99/p999 per interval) derived from the cumulative
``LatHist`` histograms the rings already keep.

Observer effect is ZERO by construction, the same discipline as the
tracer and pinned by the same kind of test
(``test_metrics_sampling_has_zero_observer_effect``):

* the sampler is driven by a hook at the top of the scheduler's run
  loop (``FiberScheduler.run`` reads the module-global ``CURRENT`` and
  calls ``maybe_sample``), NOT by a fiber — a fiber sitting in the
  ready queue would perturb ``ready_count()``, which the adaptive
  submit/flush policies read, and would no longer be invisible;
* every sample only *reads* clocks and counters; nothing here charges
  CPU, schedules a timeline event, or touches scheduler state, so the
  simulation is bit-identical with sampling on or off;
* sampling cadence is therefore quantized to scheduler steps: the
  sample for interval boundary ``k*interval_s`` is taken at the first
  scheduler step at or past the boundary, stamped with the actual
  virtual time (series are sparse — a long I/O wait yields no
  intermediate points, exactly like a real scrape hitting an idle
  process).

Subsystems expose their stat surfaces via ``register_metrics(reg,
prefix)`` methods (ring, buffer pool, group commit, replication
cluster, shuffle engine); ``StorageEngine`` wires its whole stack under
one prefix when a registry is installed.  Series names follow
``<subsystem-prefix>/<metric>`` with windowed-digest names
``<prefix>/lat/<op_class>/p{50,99,999}_us`` — see
docs/observability.md for the naming scheme.

Usage (or ``benchmarks/run.py --metrics out.json``)::

    from repro.observe import metrics
    reg = metrics.MetricsRegistry(interval_s=1e-3)
    metrics.install(reg)
    ...                       # run anything on the ring runtime
    metrics.uninstall()
    reg.write("out.json")
"""

from __future__ import annotations

import json
import math
from typing import Callable, Dict, List, Optional

#: the installed registry; the FiberScheduler run loop reads this
#: module attribute directly (install/uninstall is instant)
CURRENT: Optional["MetricsRegistry"] = None

#: serialization version of the --metrics dump
DUMP_VERSION = 1


class Series:
    """One named time-series: parallel (t, v) arrays."""

    __slots__ = ("name", "unit", "kind", "t", "v")

    def __init__(self, name: str, unit: str = "", kind: str = "gauge"):
        self.name = name
        self.unit = unit
        self.kind = kind              # gauge | counter | rate | digest
        self.t: List[float] = []
        self.v: List[float] = []

    def add(self, t: float, v: float) -> None:
        self.t.append(t)
        self.v.append(v)

    def last(self) -> Optional[float]:
        return self.v[-1] if self.v else None


def _delta_percentile(counts: List[int], n: int, p: float,
                      floor: float) -> float:
    """Geometric-midpoint percentile over a log2 bucket-count delta
    (the windowed analogue of ``LatHist.percentile``)."""
    if n <= 0:
        return 0.0
    target = p / 100.0 * n
    cum = 0
    for b, c in enumerate(counts):
        cum += c
        if cum >= target:
            if b == 0:
                return floor / 2
            return math.sqrt((floor * 2 ** (b - 1)) * (floor * 2 ** b))
    return floor * 2 ** (len(counts) - 1)


class MetricsRegistry:
    """Source registry + sampler + series store.

    ``interval_s`` is the sampling cadence in *virtual* seconds;
    ``max_ticks`` bounds the number of sample rounds (the time-series
    equivalent of the tracer's 2M-event cap — a full-scale bench can't
    eat the heap; ``truncated`` flags the cut)."""

    def __init__(self, *, interval_s: float = 1e-3,
                 max_ticks: int = 4096):
        assert interval_s > 0.0
        self.interval_s = interval_s
        self.max_ticks = max_ticks
        self.series: Dict[str, Series] = {}
        self.ticks = 0
        self.truncated = False
        self._next = 0.0              # next sample boundary (virtual s)
        self._prefixes: Dict[str, int] = {}
        # source tables; each entry samples into one or more series
        self._gauges: List[tuple] = []     # (series, fn)
        self._counters: List[tuple] = []   # (series, fn)
        self._wrates: List[list] = []      # [series, num_fn, den_fn,
                                           #  prev_num, prev_den]
        self._wgroups: List[list] = []     # [prefix, fn, den_fn, unit,
                                           #  prev: Dict[str, float],
                                           #  prev_den]
        self._hists: List[list] = []       # [prefix, fn,
                                           #  prev: Dict[cls, (n, counts)]]

    # ------------------------------------------------------ registration

    def unique(self, base: str) -> str:
        """Collision-free instance prefix: ``tpcc``, ``tpcc#2``, ..."""
        n = self._prefixes.get(base, 0) + 1
        self._prefixes[base] = n
        return base if n == 1 else f"{base}#{n}"

    def _mk(self, name: str, unit: str, kind: str) -> Series:
        assert name not in self.series, f"duplicate series {name!r}"
        s = Series(name, unit, kind)
        self.series[name] = s
        return s

    def gauge(self, name: str, fn: Callable[[], float],
              unit: str = "") -> None:
        """Instantaneous value sampled as-is (queue depth, free frames)."""
        self._gauges.append((self._mk(name, unit, "gauge"), fn))

    def counter(self, name: str, fn: Callable[[], float],
                unit: str = "") -> None:
        """Monotonic cumulative value sampled as-is (enters, commits);
        consumers window it by differencing neighbouring samples."""
        self._counters.append((self._mk(name, unit, "counter"), fn))

    def wrate(self, name: str, num_fn: Callable[[], float],
              den_fn: Optional[Callable[[], float]] = None,
              unit: str = "") -> None:
        """Windowed rate: Δnum/Δden over each interval.  ``den_fn=None``
        divides by elapsed virtual time (per-second rates: tps).  No
        point is emitted for a window with Δden == 0 (series are
        sparse)."""
        self._wrates.append(
            [self._mk(name, unit, "rate"), num_fn, den_fn, None, None])

    def wgroup(self, prefix: str, fn: Callable[[], Dict[str, float]],
               den_fn: Optional[Callable[[], float]] = None,
               unit: str = "share") -> None:
        """Windowed per-key shares of a dynamic dict source — e.g.
        attribution categories: Δattr[cat]/Δcharged-CPU per interval.
        Keys may appear mid-run; each gets its own series lazily."""
        self._wgroups.append([prefix, fn, den_fn, unit, {}, None])

    def hists(self, prefix: str,
              fn: Callable[[], Dict[str, object]]) -> None:
        """Windowed percentile digests over cumulative ``LatHist``s
        (``fn`` returns op_class -> LatHist): each interval's bucket
        delta yields ``<prefix>/<cls>/p{50,99,999}_us`` points."""
        self._hists.append([prefix, fn, {}])

    # ---------------------------------------------------------- sampling

    def maybe_sample(self, now: float) -> None:
        """Scheduler-loop hook: take a sample if an interval boundary
        has passed.  Pure reads — safe to call anywhere, any number of
        times (zero observer effect)."""
        if now + self.interval_s < self._next:
            # virtual time jumped backwards: a fresh engine (its own
            # Timeline starting at 0) began running under the same
            # registry — re-quantize instead of stalling forever
            self._next = (math.floor(now / self.interval_s) + 1) * \
                self.interval_s
        if now < self._next:
            return
        self.sample(now)
        # re-quantize so a long idle gap yields ONE late sample, not a
        # burst of catch-up samples at the same instant
        self._next = (math.floor(now / self.interval_s) + 1) * \
            self.interval_s

    def sample(self, now: float) -> None:
        """Record one sample round at virtual time ``now``."""
        if self.ticks >= self.max_ticks:
            self.truncated = True
            return
        self.ticks += 1
        for s, fn in self._gauges:
            s.add(now, fn())
        for s, fn in self._counters:
            s.add(now, fn())
        for ent in self._wrates:
            s, num_fn, den_fn, pn, pd = ent
            num = num_fn()
            den = now if den_fn is None else den_fn()
            if pn is not None and den > pd:
                s.add(now, (num - pn) / (den - pd))
            ent[3], ent[4] = num, den
        for ent in self._wgroups:
            prefix, fn, den_fn, unit, prev, pd = ent
            cur = fn()
            den = now if den_fn is None else den_fn()
            if pd is not None and den > pd:
                dd = den - pd
                for k, v in cur.items():
                    dv = v - prev.get(k, 0.0)
                    if dv <= 0.0 and k not in prev:
                        continue
                    name = f"{prefix}/{k}"
                    s = self.series.get(name) or \
                        self._mk(name, unit, "rate")
                    s.add(now, dv / dd)
            ent[4] = dict(cur)
            ent[5] = den
        for ent in self._hists:
            prefix, fn, prev = ent
            for cls, h in fn().items():
                pn, pc = prev.get(cls, (0, None))
                dn = h.n - pn
                if dn > 0:
                    dc = [c - (pc[b] if pc else 0)
                          for b, c in enumerate(h.counts)]
                    for p, tag in ((50.0, "p50_us"), (99.0, "p99_us"),
                                   (99.9, "p999_us")):
                        name = f"{prefix}/{cls}/{tag}"
                        s = self.series.get(name) or \
                            self._mk(name, "us", "digest")
                        s.add(now, _delta_percentile(
                            dc, dn, p, h.FLOOR) * 1e6)
                prev[cls] = (h.n, list(h.counts))

    # ------------------------------------------------------------ export

    @property
    def n_points(self) -> int:
        return sum(len(s.t) for s in self.series.values())

    def to_json(self) -> dict:
        return {
            "dump_version": DUMP_VERSION,
            "interval_s": self.interval_s,
            "ticks": self.ticks,
            "truncated": self.truncated,
            "series": [
                {"name": s.name, "unit": s.unit, "kind": s.kind,
                 "t": [round(t, 9) for t in s.t],
                 "v": [round(v, 6) if isinstance(v, float) else v
                       for v in s.v]}
                for s in self.series.values()],
        }

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)


def install(reg: MetricsRegistry) -> MetricsRegistry:
    """Make ``reg`` the process-wide sampling sink."""
    global CURRENT
    CURRENT = reg
    return reg


def uninstall() -> None:
    global CURRENT
    CURRENT = None


def current() -> Optional[MetricsRegistry]:
    return CURRENT
