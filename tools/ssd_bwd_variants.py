#!/usr/bin/env python3
"""Time compile-time variants of the SSD backward's bf16 kernels on one card.

Run from the repository root, on a machine with a CUDA card and ``nvcc``:

    python3 tools/ssd_bwd_variants.py

Each variant is ``src/repro_torch/csrc/ssd_bwd.cu`` with a few lines
replaced (the table ``VARIANTS`` below), built by ``nvcc`` with the port's
flags into ``build/variants/`` and called through its C entry point like
``kernels.ssd_scan.kernel.ssd_chunk_bwd``. Printed for each: the head
kernel instances' spill bytes (the compiler's report), and device ms a
call at zamba2-2.7b's and mamba2-130m's training calls (CUDA events,
``chip_smoke.cuda_ms``), the variants in turn within one process, and
whether its outputs equal the source's bit for bit. The variants:

* ``source``: the file as it is;
* ``group4``, ``group16``: 4 or 16 heads a CTA of the head kernel (8);
* ``pdy_pieces2``: P and dy in two bf16 pieces for Pᵀ·dy (three): the
  precision the CPU twin shows is needed, for its cost in time;
* ``spilling``: cs_j and dt_j held in registers across the row tiles,
  and the column sums of r too: the build two of the source's register
  savers replace.
"""

from __future__ import annotations

import ctypes
import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch                                                  # noqa: E402

import chip_smoke as cs                                       # noqa: E402
from repro_torch.kernels import _build                        # noqa: E402

SRC = ROOT / "src" / "repro_torch" / "csrc" / "ssd_bwd.cu"
OUT = ROOT / "build" / "variants"
SHAPES = {"zamba2-2.7b": (1, 4096, 80, 64, 64, 256),
          "mamba2-130m": (2, 4096, 24, 64, 128, 256)}

_ELEMENT_SMEM = """\
              Lv = __expf(float(ci[e & 1] -
                                cs[min(j0 + (e < 2 ? ja : jb), a.cl - 1)]));
            // cs_j and dt_j reread from shared memory: in registers across
            // the row tiles they would be spilled
            const float gv = gacc[q][e] * dtk[e < 2 ? ja : jb];"""
_ELEMENT_REGS = """\
              Lv = __expf(float(ci[e & 1] - (e < 2 ? csa : csb)));
            const float gv = gacc[q][e] * (e < 2 ? dta : dtb);"""
_COLS_INIT = """\
    // the column sums of r (Σ_i r, keys ja / jb) accumulate in shared
    // memory, a k step at a time, by the lane t = 0 that owns the key
    if (t == 0) {
      Rex[2 * TILE + nw * TILE + ja] = 0.f;
      Rex[2 * TILE + nw * TILE + jb] = 0.f;
    }
"""
_COLS_STEP = """\
        cola += __shfl_xor_sync(0xffffffffu, cola, 1);
        cola += __shfl_xor_sync(0xffffffffu, cola, 2);
        colb += __shfl_xor_sync(0xffffffffu, colb, 1);
        colb += __shfl_xor_sync(0xffffffffu, colb, 2);
        if (t == 0) {
          Rex[2 * TILE + nw * TILE + ja] += cola;
          Rex[2 * TILE + nw * TILE + jb] += colb;
        }
"""
_COLS_END = """\
    float4* xch = reinterpret_cast<float4*>(Rdy);"""
VARIANTS = {
    "source": [],
    "group4": [("constexpr int GROUP = 8;", "constexpr int GROUP = 4;")],
    "group16": [("constexpr int GROUP = 8;", "constexpr int GROUP = 16;")],
    "pdy_pieces2": [("constexpr int PB = 3;", "constexpr int PB = 2;")],
    "spilling": [
        (_ELEMENT_SMEM, _ELEMENT_REGS),
        (_COLS_INIT, "    float cola = 0.f, colb = 0.f;\n"),
        ("        float cola = 0.f, colb = 0.f;\n", ""),
        (_COLS_STEP, ""),
        (_COLS_END, _COLS_STEP.replace("        ", "    ").replace(
            "+= cola", "= cola").replace("+= colb", "= colb") + _COLS_END)],
}


def start_build(name, subs):
    """The variant's source written and its nvcc started: (library path,
    process)."""
    text = SRC.read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise ValueError(f"{name}: the source no longer holds {old!r}")
        text = text.replace(old, new)
    cu = OUT / f"{name}.cu"
    cu.write_text(text)
    lib = cu.with_suffix(".so")
    return lib, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                                  str(lib), str(cu)], stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def finish_build(name, proc):
    """The head kernels' spill report of a finished build."""
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{log}")
    spills, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and entry and "mma_head_kernel" in entry:
            inst = re.search(r"ILi(\d+)ELi(\d+)E", entry)
            spills.append(f"<{inst.group(1)},{inst.group(2)}> "
                          f"{m.group(1)} B")
    return spills


def call(lib, x, dt, A_log, B_, C_, dy, dst, decs, detot, cl):
    B, S, nh, hp = x.shape
    ws = lib.ssd_bwd_workspace
    ws.argtypes, ws.restype = [ctypes.c_int] * 4, ctypes.c_int
    scratch = torch.empty(ws(B, S, nh, cl), dtype=torch.uint8,
                          device=x.device)
    outs = [torch.empty_like(t) for t in (x, dt, A_log, B_, C_)]
    fn = lib.ssd_bwd_bf16
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*(t.data_ptr() for t in (x, dt, A_log, B_, C_, dy, dst, decs,
                                      detot, *outs, scratch)),
             B, S, nh, hp, B_.shape[-1], cl, _build.stream_handle(x.device))
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return outs


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    shutil.copy(SRC.parent / "mma_sync.cuh", OUT / "mma_sync.cuh")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    started = {name: start_build(name, subs)            # nvcc in parallel
               for name, subs in VARIANTS.items()}
    libs = {}
    for name, (path, proc) in started.items():
        spills = finish_build(name, proc)
        libs[name] = ctypes.CDLL(str(path))
        print(f"{name}: head kernel spill stores {', '.join(spills)}")
    dev, rng = torch.device("cuda"), cs.np.random.default_rng(0)
    for what, (B, S, nh, hp, ns, cl) in SHAPES.items():
        nc = S // cl
        sets = [cs.ssd_inputs(rng, dev, B, S, nh, hp, ns, torch.bfloat16)
                + tuple(cs.rand(rng, shape, torch.float32, dev) for shape in (
                    (B, nc, cl, nh, hp), (B, nc, nh, hp, ns),
                    (B, nc, cl, nh), (B, nc, nh))) for _ in range(2)]
        ref = call(libs["source"], *sets[0], cl)
        line = []
        for name, lib in libs.items():
            same = all(torch.equal(a, b)
                       for a, b in zip(call(lib, *sets[0], cl), ref))
            ms = cs.cuda_ms(lambda i: call(lib, *sets[i], cl), 2, 10,
                            warmup=2)
            line.append(f"{name} {ms:.4f} ms{'' if same else ' (other bits)'}")
        print(f"{what} {(B, S, nh, hp)} ns {ns} cl {cl}: " + "; ".join(line))
        del sets, ref
        cs.free_card()
    return 0


if __name__ == "__main__":
    sys.exit(main())
