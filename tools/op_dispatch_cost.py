#!/usr/bin/env python3
"""Host time a call of the decode path's kernel ops costs through the
torch dispatcher (``torch.ops.repro_torch.*``, ``kernels.kernel_op``) and
through their implementations called directly, as before they were
registered ops, on one card.

Run from the repository root, on a machine with a CUDA card and ``nvcc``:

    python3 tools/op_dispatch_cost.py

The ops at the decode shapes of ``chip_smoke.py``'s serving runs: the
paged op at stablelm-1.6b's (q (4, 32, 64), 34 pages of 16, length 543)
with and without lse, and the SSD chunk op at zamba2-2.7b's decode step
(x (4, 1, 80, 64), ns 64, a chunk of one token); and, for comparison,
the paged op registered as a ``torch.library.custom_op``. For each, host
microseconds a call over 2000 back-to-back calls (the stream held busy
meanwhile, so the host never waits on the card, as ``chip_smoke.cuda_ms``
does), in turns op, direct, direct, op, five times; printed are the
medians and their difference, beside the card's ``nvidia-smi`` name and
power limit.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch                                                  # noqa: E402

from repro_torch.kernels import _build                        # noqa: E402
from repro_torch.kernels.paged_attn import ops as paged_ops    # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops        # noqa: E402
from repro_torch.models import lm                              # noqa: E402

CALLS, ROUNDS = 2000, 5


def host_us(fn, args):
    """Host us a call of ``fn(*args)`` over CALLS calls queued behind a
    held stream."""
    for _ in range(20):
        fn(*args)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(4e8))        # keeps the card busy while we queue
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn(*args)
    us = (time.perf_counter() - t0) / CALLS * 1e6
    torch.cuda.synchronize()
    return us


def main() -> int:
    if not torch.cuda.is_available():
        print("op_dispatch_cost: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}")
    _build.build(["paged_attn", "ssd_chunk"])
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    bf = torch.bfloat16
    B, H, hd, L = 4, 32, 64, 544
    q = torch.randn((B, H, hd), generator=g, device=dev).to(bf)
    pool = torch.randn((B * L // 16, 16, H, hd), generator=g,
                       device=dev).to(bf)
    table, lens = lm.identity_pages(B, L, L - 2, 0, dev)
    paged = (q, pool, pool, table, lens, hd ** -0.5)
    x = torch.randn((B, 1, 80, 64), generator=g, device=dev).to(bf)
    dt = torch.rand((B, 1, 80), generator=g, device=dev)
    A_log = torch.rand((80,), generator=g, device=dev)
    bc = torch.randn((B, 1, 64), generator=g, device=dev).to(bf)
    ssd = (x, dt, A_log, bc, bc, 1)
    cases = (("paged (stablelm decode)", torch.ops.repro_torch.paged_attention,
              paged_ops._route, paged),
             ("paged + lse", torch.ops.repro_torch.paged_attention_lse,
              paged_ops._route_lse, paged),
             ("ssd chunk (zamba2 decode)", torch.ops.repro_torch.ssd_chunk,
              ssd_ops._chunk, ssd))
    # the same route as a torch.library.custom_op, for comparison
    custom = torch.library.custom_op("repro_torch_cmp::paged_attention",
                                     paged_ops._route, mutates_args=())
    custom.register_fake(paged_ops._fake)
    cases += (("paged as a custom_op", custom, paged_ops._route, paged),)
    for what, op, direct, args in cases:
        runs = {"op": [], "direct": []}
        for _ in range(ROUNDS):
            for kind in ("op", "direct", "direct", "op"):
                runs[kind].append(host_us(op if kind == "op" else direct,
                                          args))
        o, d = (float(np.median(runs[k])) for k in ("op", "direct"))
        print(f"{what}: through the dispatcher {o:.2f} us a call, direct "
              f"{d:.2f} us, difference {o - d:.2f} us (host clock, medians "
              f"of {2 * ROUNDS} runs of {CALLS} calls each, in turns; "
              f"spread op {min(runs['op']):.2f}-{max(runs['op']):.2f}, "
              f"direct {min(runs['direct']):.2f}-"
              f"{max(runs['direct']):.2f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
