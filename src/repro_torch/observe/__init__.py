"""The port's copy of ``repro.observe``: the passive event sink that
``core/ring.py`` reports to (``trace``), the virtual-clock time series
(``metrics``), the guideline advisor (``advisor``) and, imported on
demand, the open-loop load generator (``slo``). Each module equals the
original except for its import lines (``tests/test_torch_ckpt.py``).
``spans`` is the port's own: spans and counters of its work on the card,
imported on demand."""

from repro_torch.observe import metrics
from repro_torch.observe.advisor import (Finding, RingReport, diagnose,
                                         report_from_result,
                                         report_from_stats)
from repro_torch.observe.metrics import MetricsRegistry
from repro_torch.observe.trace import Tracer, current, install, uninstall
