"""Quickstart: the io_uring-style ring runtime in 40 lines, on the port's
copy of it (``repro_torch.core``). The twin of ``examples/quickstart.py``;
the ring is host code and runs the same on any machine.

    PYTHONPATH=src python examples/quickstart_torch.py
"""

from repro_torch.core import (AdaptiveBatcher, FiberScheduler, IoRequest,
                              IoUring, SetupFlags, SimNVMe, Timeline)
from repro_torch.core import ring as R


def main():
    tl = Timeline()
    ring = IoUring(tl, setup=SetupFlags.DEFER_TASKRUN |
                   SetupFlags.SINGLE_ISSUER)
    ring.register_device(3, SimNVMe(tl))        # the paper's SSD array

    # --- raw ring usage: batched submission, one syscall -----------------
    for i in range(16):
        sqe = ring.get_sqe()
        R.prep_read(sqe, 3, bytearray(4096), i * 4096, 4096, user_data=i)
    ring.submit()                                # ONE io_uring_enter
    ring.wait_cqes(16)
    print(f"16 reads: t={tl.now*1e6:.0f}us  enters={ring.stats.enters}  "
          f"batch_eff={ring.stats.batch_efficiency():.0f}")

    # --- fibers: overlap I/O with other transactions ----------------------
    sched = FiberScheduler(ring, policy=AdaptiveBatcher())

    def txn(i):
        cqe = yield IoRequest(lambda sqe, ud, i=i: R.prep_read(
            sqe, 3, bytearray(4096), i * 4096, 4096))
        assert cqe.res == 4096
        return i

    t0 = tl.now
    for i in range(64):
        sched.spawn(txn(i))
    sched.run()
    print(f"64 overlapped reads via fibers: {1e6*(tl.now-t0):.0f}us "
          f"(vs {64*70:.0f}us if serial)")


if __name__ == "__main__":
    main()
