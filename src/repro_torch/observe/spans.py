"""Spans and counters on the card: where the program's time goes, read
without a profiler.

``span(name, mark=None)`` always enters a
``torch.profiler.record_function(name)`` range, so a profile places the
span on its clock beside the kernels launched inside it; without a
profiler that costs a few host microseconds. While the recorder is on
(``enable()``) a span also keeps a record: its name, the index of the
span it opened in (on its thread; ``None`` for a root), its host start
and end (``time.perf_counter_ns``) and, when ``mark`` names a device, a
mark at entry and at exit on that device's clock: a
``torch.cuda.Event(enable_timing=True)`` recorded on the current stream
(no synchronise) on a CUDA device, the host clock on the CPU.

``count(name, value)`` adds ``value`` (a tensor, summed on its device
without a synchronise, or a Python number) into the counter ``name``;
callers guard it with ``on()``, so with the recorder off nothing is
reduced. ``take()`` synchronises once and hands back the records, each
mark converted to ms on its device's clock (differences between marks of
one device are meaningful; the origin is the first mark taken), and the
counters' totals; it empties the recorder and leaves it on. Call it
outside every span.

Off by default; there is no environment switch and no exporter (the
profiler's timeline is the export). Names start with ``serve_``,
``train_``, ``optim_`` or ``moe_`` (``PREFIXES``).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.profiler import record_function

PREFIXES = ("serve_", "train_", "optim_", "moe_")


class Record(NamedTuple):
    name: str
    parent: Optional[int]        # index of the enclosing record, or None
    t0_ns: int                   # host clock (perf_counter_ns)
    t1_ns: Optional[int]         # None while the span is open
    mark0_ms: Optional[float]    # device clock at entry (with ``mark``)
    mark1_ms: Optional[float]    # device clock at exit


def _mark(device):
    if device is None:
        return None
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter_ns()


class _Recorder:
    def __init__(self):
        # [name, parent, t0_ns, t1_ns, mark0, mark1, device]
        self.records: List[list] = []
        self.local = threading.local()
        self.counters: Dict[str, object] = {}

    def open(self, name, device) -> list:
        stack = self.local.__dict__.setdefault("stack", [])
        row = [name, stack[-1] if stack else None, time.perf_counter_ns(),
               None, _mark(device), None, device]
        stack.append(len(self.records))
        self.records.append(row)
        return row

    def close(self, row: list):
        row[5] = _mark(row[6])
        row[3] = time.perf_counter_ns()
        self.local.stack.pop()


_rec: Optional[_Recorder] = None


class span:
    """``with span(name, mark=device): ...``, ``mark`` a ``torch.device``
    or None; see the module docstring."""

    __slots__ = ("name", "mark", "rf", "row", "rec")

    def __init__(self, name: str, mark=None):
        self.name = name
        self.mark = mark

    def __enter__(self):
        self.rf = record_function(self.name)
        self.rf.__enter__()
        self.rec = _rec
        self.row = None if self.rec is None else \
            self.rec.open(self.name, self.mark)
        return self

    def __exit__(self, *exc):
        if self.row is not None:
            self.rec.close(self.row)
        return self.rf.__exit__(*exc)


def on() -> bool:
    return _rec is not None


def enable():
    """Turn the recorder on (a no-op when it is on)."""
    global _rec
    if _rec is None:
        _rec = _Recorder()


def disable():
    """Turn the recorder off; what was not taken is dropped."""
    global _rec
    _rec = None


def count(name: str, value):
    """Add ``value`` into the counter ``name`` (no-op with the recorder
    off). A tensor is summed into a 0-d accumulator on its device (a
    bool tensor counts its true elements)."""
    r = _rec
    if r is None:
        return
    if isinstance(value, torch.Tensor):
        value = value.detach().sum()
        acc = r.counters.get(name)
        if acc is None:
            # a plain tensor, so that inference mode and autograd both
            # may add into it
            with torch.inference_mode(False):
                acc = torch.zeros((), dtype=value.dtype,
                                  device=value.device)
            r.counters[name] = acc
        acc.add_(value)
    else:
        r.counters[name] = r.counters.get(name, 0) + value


def take() -> Tuple[List[Record], Dict[str, float]]:
    """(records, counter totals) since ``enable()`` or the last ``take()``,
    after one synchronise; empties the recorder and leaves it on."""
    r = _rec
    if r is None:
        return [], {}
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    first: Dict[type, object] = {}

    def ms(m):
        if m is None:
            return None
        ref = first.setdefault(type(m), m)
        if isinstance(m, torch.cuda.Event):
            return float(ref.elapsed_time(m))
        return (m - ref) * 1e-6
    out = [Record(x[0], x[1], x[2], x[3], ms(x[4]), ms(x[5]))
           for x in r.records]
    counters = {k: v.item() if isinstance(v, torch.Tensor) else v
                for k, v in r.counters.items()}
    r.records, r.counters = [], {}
    return out, counters
