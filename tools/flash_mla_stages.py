#!/usr/bin/env python3
"""Time the flash forward's bf16 kernel at MLA's head dims (q/k 192, v 128)
with 2 and with 3 K/V stages in flight, on one card.

Run from the repository root, on a machine with a CUDA card and ``nvcc``:

    python3 tools/flash_mla_stages.py

Each variant is ``src/repro_torch/csrc/flash_fwd.cu`` built by ``nvcc``
with the port's flags and ``-DFLASH_MLA_STAGES=2`` or ``3`` (the source's
default is 2) into ``build/variants/`` and called through
its C entry point as ``kernels.flash_attention.kernel.flash_attention_fwd``
calls it. A stage is 40 KB (K 24 + V 16) beside the 24 KB q tile: two
stages make a CTA of 104 KB (two an SM), three of 144 KB (one). Printed
for each: its CTA (threads, shared bytes, CTAs an SM), the compiler's
register and spill line for the (192, 128) instance, its largest error
against the plain version (``ref.flash_attention_fwd_ref``) and whether
its output equals the other variant's bit for bit, and device ms a call
at deepseek-v2-lite-16b's prefill (4, 512, 16 heads) and at a training
call's length (2, 4096, 16 heads), in turns within one process (CUDA
events, ``chip_smoke.cuda_ms``).
"""

from __future__ import annotations

import ctypes
import math
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np                                            # noqa: E402
import torch                                                  # noqa: E402

import chip_smoke as cs                                       # noqa: E402
from repro_torch.kernels import _build                        # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_fwd_ref                                   # noqa: E402

SRC = _build.CSRC / "flash_fwd.cu"
OUT = ROOT / "build" / "variants"
STAGES = (2, 3)
SHAPES = {"deepseek-v2-lite prefill": (4, 512, 16),
          "a training call's length": (2, 4096, 16)}


def start_build(stages: int):
    lib = OUT / f"flash_fwd_mla_stages{stages}.so"
    return lib, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, f"-DFLASH_MLA_STAGES={stages}",
         "-I", str(_build.CSRC), "-o", str(lib), str(SRC)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def report(proc, stages):
    """The compiler's register / spill lines for the (192, 128) bf16
    instance."""
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"stages {stages}: nvcc failed\n{log}")
    out, entry = [], ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        if "flash_fwd_bf16_kernelILi192ELi128E" in entry and (
                "Used" in line or "spill" in line):
            out.append(line.strip())
    return out


def call(lib, q, k, v):
    B, S, H, hd = q.shape
    fn = lib.flash_fwd_bf16
    fn.argtypes, fn.restype = fk._ARGTYPES, ctypes.c_int
    o = torch.empty((B, S, H, v.shape[-1]), dtype=q.dtype, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None,
             B, S, S, H, k.shape[2], hd, v.shape[-1],
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *o.stride()[:3], 1.0 / math.sqrt(hd), 1, 0,
             _build.stream_handle(q.device))
    if err:
        raise RuntimeError(f"flash_fwd_bf16: CUDA error {err}")
    return o


def plan(lib):
    fn = lib.flash_fwd_bf16_plan
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 3)()
    if fn(192, 128, ctypes.cast(out, ctypes.c_void_p)):
        raise RuntimeError("flash_fwd_bf16_plan failed")
    return dict(zip(("threads", "smem_bytes", "ctas_per_sm"), out))


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_mla_stages: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    OUT.mkdir(parents=True, exist_ok=True)
    variants = STAGES
    started = {s: start_build(s) for s in variants}      # nvcc in parallel
    libs = {}
    for s, (path, proc) in started.items():
        lines = report(proc, s)
        libs[s] = ctypes.CDLL(str(path))
        print(f"stages {s}: "
              f"{plan(libs[s])}; ptxas: {' | '.join(lines)}")
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    for what, (B, S, H) in SHAPES.items():
        sets = [tuple(cs.rand(rng, (B, S, H, d), torch.bfloat16, dev)
                      for d in (192, 192, 128)) for _ in range(4)]
        outs = {s: call(lib, *sets[0]) for s, lib in libs.items()}
        ref, _ = flash_attention_fwd_ref(*sets[0], scale=1 / math.sqrt(192))
        errs = {s: float((o.float() - ref.float()).abs().max())
                for s, o in outs.items()}
        same = torch.equal(*outs.values())
        ms = {s: [] for s in libs}
        for s in variants + variants[::-1]:             # a, b, b, a
            ms[s].append(cs.cuda_ms(lambda i: call(libs[s], *sets[i]), 4,
                                    max(10, 200 * 512 // S), warmup=3))
        print(f"{what} q/k {(B, S, H, 192)} v 128 bf16 causal: "
              + "; ".join(f"stages {s}: {np.mean(t):.4f} ms "
                          f"({', '.join(f'{x:.4f}' for x in t)}), max abs "
                          f"err vs plain {errs[s]:.3e}" for s, t in ms.items())
              + f"; outputs bit-identical: {same}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
