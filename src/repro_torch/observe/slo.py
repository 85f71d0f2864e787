"""Open-loop SLO harness: Poisson arrivals on the virtual clock.

The benchmark loops elsewhere in this repo are CLOSED: a fixed fiber
count issues the next transaction the moment the previous one acks, so
measured latency is service time and throughput is whatever the engine
sustains.  Real systems face OPEN arrivals — clients show up at a rate
the server does not control, queueing delay explodes near saturation,
and the number that matters is the tail of *arrival-to-completion*
latency against a declared SLO (coordinated omission is exactly what a
closed loop hides).

This module drives a ``StorageEngine`` (or a ``ReplicatedCluster``'s
primary) with an open-loop Poisson process:

* arrival times are pregenerated from a seeded exponential
  inter-arrival stream (deterministic per seed, as everything here);
* a *pacer* fiber sleeps between arrivals on TIMEOUT SQEs — the sleep
  rides the engine's own ring, so the pacer holds an inflight op and
  the scheduler never mistakes an idle instant for termination;
* due arrivals enter a bounded queue (``queue_cap``); arrivals that
  find it full are DROPPED and counted — an overloaded open system
  must shed, not buffer without bound;
* ``n_workers`` service fibers pop arrivals, run one transaction each,
  and record ``now - t_arrival`` (queue wait INCLUDED) in a
  ``LatHist``; they park on a gate while the queue is empty.

``run_open_loop`` returns p50/p99/p999 commit latency, the drop/shed
count, and achieved throughput at the offered rate; ``sweep`` runs a
fresh engine per rate and stamps each row against the declared SLO.
These feed the ``slo/*`` sections of ``benchmarks/run.py --json`` and
the regression gate in ``scripts/bench_diff.py``.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.fibers import Gate, IoRequest
from repro_torch.core.ring import prep_timeout
from repro_torch.core.sqe import LatHist


def poisson_arrivals(rate_tps: float, duration_s: float,
                     seed: int = 7) -> List[float]:
    """Arrival times in [0, duration_s) of a Poisson process with the
    given rate, deterministic per seed."""
    assert rate_tps > 0 and duration_s > 0
    rng = np.random.default_rng(seed)
    out: List[float] = []
    t = 0.0
    while True:
        # draw in blocks; exponential inter-arrivals => Poisson counts
        block = rng.exponential(1.0 / rate_tps, size=256)
        for dt in block:
            t += float(dt)
            if t >= duration_s:
                return out
            out.append(t)


def run_open_loop(engine, make_txn, *, rate_tps: float,
                  duration_s: float, n_workers: int = 64,
                  queue_cap: int = 256, seed: int = 7) -> Dict:
    """Drive ``engine`` with open-loop Poisson arrivals and measure
    arrival-to-completion latency.

    ``engine`` is a ``StorageEngine`` or a ``ReplicatedCluster`` (the
    workload runs on its primary; the replication fibers ride along via
    ``spawn_service_fibers`` exactly as in the closed-loop path).
    ``make_txn(rng)`` returns one transaction's fiber generator, same
    contract as ``StorageEngine.run_fibers``.  Uses a FRESH engine per
    call — arrival latency would otherwise mix with whatever the engine
    ran before.
    """
    eng = getattr(engine, "primary", engine)
    tl, sched = eng.tl, eng.sched
    arrivals = poisson_arrivals(rate_tps, duration_s, seed=seed)
    offered = len(arrivals)
    rng = np.random.default_rng(seed + 1)

    queue: deque = deque()          # pending (t_arrival) entries
    gate = Gate(sched)
    hist = LatHist()
    state = {"done": False, "dropped": 0, "completed": 0}

    def pacer():
        """Releases arrivals at their scheduled virtual times.  The
        inter-arrival sleep is a TIMEOUT SQE on ring 0 — an inflight op
        keeps the scheduler alive while every worker is parked."""
        for t_arr in arrivals:
            dt = t_arr - tl.now
            if dt > 0:
                yield IoRequest(lambda sqe, _ud, dt=dt:
                                prep_timeout(sqe, dt))
            if len(queue) >= queue_cap:
                state["dropped"] += 1     # shed: the queue is bounded
            else:
                queue.append(t_arr)
                gate.open()
        state["done"] = True
        gate.open()

    def worker():
        while True:
            if queue:
                t_arr = queue.popleft()
                yield from make_txn(rng)
                hist.record(tl.now - t_arr)
                state["completed"] += 1
            elif state["done"]:
                return
            else:
                yield gate

    t0 = tl.now
    workers = []
    for i in range(n_workers):
        if eng.mc:
            c = i % eng.n_cores
            workers.append(sched.spawn(
                worker(), core=c,
                ring=0 if eng.cfg.shared_ring else c,
                name=f"slo-worker{i}"))
        else:
            workers.append(sched.spawn(worker(), name=f"slo-worker{i}"))
    all_done = lambda: (state["done"] and not queue and     # noqa: E731
                        all(f.done for f in workers))
    eng.spawn_service_fibers(workers, all_done)
    sched.spawn(pacer(), core=0, ring=0, name="slo-pacer")
    sched.run()

    end = tl.now if not eng.mc else \
        max([tl.now] + [c.free for c in eng._own_cores])
    dt = max(end - t0, 1e-12)
    return {
        "rate_tps": rate_tps,
        "duration_s": duration_s,
        "offered": offered,
        "completed": state["completed"],
        "dropped": state["dropped"],
        "drop_frac": state["dropped"] / max(1, offered),
        "achieved_tps": state["completed"] / dt,
        "p50_us": hist.percentile(50.0) * 1e6,
        "p99_us": hist.percentile(99.0) * 1e6,
        "p999_us": hist.percentile(99.9) * 1e6,
        "mean_us": hist.mean() * 1e6,
        "hist": hist,
    }


def sweep(make_engine: Callable[[], object], make_txn_for,
          *, rates: List[float], duration_s: float,
          slo_p99_us: float, n_workers: int = 64,
          queue_cap: int = 256, seed: int = 7,
          slo_p999_us: Optional[float] = None) -> List[Dict]:
    """Run ``run_open_loop`` at each offered rate on a FRESH engine and
    stamp each row against the declared SLO.  ``make_engine()`` builds
    the engine; ``make_txn_for(engine)`` returns its ``make_txn``."""
    rows = []
    for rate in rates:
        engine = make_engine()
        r = run_open_loop(engine, make_txn_for(engine),
                          rate_tps=rate, duration_s=duration_s,
                          n_workers=n_workers, queue_cap=queue_cap,
                          seed=seed)
        r.pop("hist")
        r["slo_p99_us"] = slo_p99_us
        r["slo_met"] = bool(r["p99_us"] <= slo_p99_us
                            and r["drop_frac"] < 0.01)
        if slo_p999_us is not None:
            r["slo_p999_us"] = slo_p999_us
            r["slo_met"] = bool(r["slo_met"]
                                and r["p999_us"] <= slo_p999_us)
        rows.append(r)
    return rows
