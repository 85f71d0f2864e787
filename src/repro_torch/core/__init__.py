"""The port's copy of the io_uring-style runtime that its checkpointer and
data loader run on (``repro.core``: SQ/CQ rings over a discrete-event
kernel/device model, registered buffers, linked and timed SQEs).

``sqe``, ``costs``, ``clock``, ``timeline``, ``backends`` and ``ring`` are
copies of the ``repro.core`` modules of the same names, equal to them
except for their import lines (``tests/test_torch_ckpt.py`` holds them to
that); the port imports nothing from ``repro``. ``fibers``, ``adaptive``
and ``faults`` are not copied yet: the KV-pager slice of the port needs
them (ROADMAP.md, Queue 1).
"""

from repro_torch.core.backends import (FileBackend, NICSpec, NVMeSpec,
                                       SimNVMe, SimNetwork, SimSocket)
from repro_torch.core.clock import CpuTimer, RealClock, VirtualClock
from repro_torch.core.costs import DEFAULT_COSTS, CostModel
from repro_torch.core.ring import (BufferRing, IoUring, prep_fsync, prep_nop,
                                   prep_read, prep_read_fixed, prep_recv,
                                   prep_send, prep_timeout, prep_uring_cmd,
                                   prep_write, prep_write_fixed)
from repro_torch.core.sqe import (CQE, SQE, CqeFlags, LatHist, Op, RingStats,
                                  SetupFlags, SqeFlags, op_class)
from repro_torch.core.timeline import CoreClock, Timeline
