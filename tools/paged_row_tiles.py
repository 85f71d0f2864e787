#!/usr/bin/env python3
"""Time the paged decode kernel at G = 6 query rows a KV head (qwen2-vl-2b,
mixtral-8x22b; hd 128) in one row tile of 6, two of 3 and six of 1, on
one card.

Run from the repository root, on a machine with a CUDA card and ``nvcc``:

    python3 tools/paged_row_tiles.py

Each variant is ``src/repro_torch/csrc/paged_attn.cu`` built by ``nvcc``
with the port's flags and ``-DPAGED_MAX_TILE_ROWS=0``, ``3`` or ``1``
(at most that many query rows a tile; 0, the source's default, takes as
many as 1024 / hd) into ``build/variants/`` and called through its C
entry point as ``kernels.paged_attn.kernel.paged_attention`` calls it.
Printed for each: its plan (row tiles, rows a tile, CTAs a cluster), its
largest error against the plain version (``ref.paged_attention_ref``),
whether its output equals the default's bit for bit, and device ms a call
over 34 pages of 16 at the last decode length of ``chip_smoke.py``'s
serving run (B 4, length 543), in turns a, b, c, c, b, a within one
process (CUDA events, ``chip_smoke.cuda_ms``).
"""

from __future__ import annotations

import ctypes
import math
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np                                            # noqa: E402
import torch                                                  # noqa: E402

import chip_smoke as cs                                       # noqa: E402
from repro_torch.kernels import _build                        # noqa: E402
from repro_torch.kernels.paged_attn import kernel as pk       # noqa: E402
from repro_torch.kernels.paged_attn.ref import \
    paged_attention_ref                                       # noqa: E402
from repro_torch.models import lm                             # noqa: E402

SRC = _build.CSRC / "paged_attn.cu"
OUT = ROOT / "build" / "variants"
MAX_ROWS = (0, 3, 1)
SHAPES = {"qwen2-vl-2b": (12, 2), "mixtral-8x22b": (48, 8)}   # H, KH
HD = 128


def start_build(rows: int):
    lib = OUT / f"paged_attn_rows{rows}.so"
    return lib, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, f"-DPAGED_MAX_TILE_ROWS={rows}",
         "-I", str(_build.CSRC), "-o", str(lib), str(SRC)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def call(lib, q, kp, vp, table, lens):
    B, H, hd = q.shape
    fn = lib.paged_attn_bf16
    fn.argtypes, fn.restype = pk._ARGTYPES, ctypes.c_int
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(),
             lens.data_ptr(), out.data_ptr(), B, H, kp.shape[2], hd,
             kp.shape[1], table.shape[1], q.stride(0), q.stride(1),
             *kp.stride()[:3], *vp.stride()[:3], table.stride(0),
             out.stride(0), out.stride(1), 1.0 / math.sqrt(hd),
             _build.stream_handle(q.device))
    if err:
        raise RuntimeError(f"paged_attn_bf16: CUDA error {err}")
    return out


def plan(lib, nblk, G):
    fn = lib.paged_attn_plan
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 7)()
    if fn(nblk, lm.PAGE_SIZE, G, HD, 1, ctypes.cast(out, ctypes.c_void_p)):
        raise RuntimeError("paged_attn_plan failed")
    return {"row_tiles": out[5], "rows_per_tile": out[6],
            "n_split": out[0], "max_active_clusters": out[4]}


def main() -> int:
    if not torch.cuda.is_available():
        print("paged_row_tiles: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    OUT.mkdir(parents=True, exist_ok=True)
    started = {r: start_build(r) for r in MAX_ROWS}      # nvcc in parallel
    libs = {}
    for r, (path, proc) in started.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"rows {r}: nvcc failed\n{log}")
        libs[r] = ctypes.CDLL(str(path))
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    B, length = cs.BATCH, cs.MAX_LEN - 1
    per_seq = cs.MAX_LEN // lm.PAGE_SIZE
    table, lens = lm.identity_pages(B, cs.MAX_LEN, length - 1, 0, dev)
    nblk = table.shape[1]
    for what, (H, KH) in SHAPES.items():
        q = cs.rand(rng, (B, H, HD), torch.bfloat16, dev)
        pools = [tuple(cs.rand(rng, (B * per_seq, lm.PAGE_SIZE, KH, HD),
                               torch.bfloat16, dev) for _ in range(2))
                 for _ in range(8)]                      # 8 x 17.8 MB
        outs = {r: call(lib, q, *pools[0], table, lens)
                for r, lib in libs.items()}
        ref = paged_attention_ref(q, *pools[0], table, lens)
        ms = {r: [] for r in libs}
        for r in MAX_ROWS + MAX_ROWS[::-1]:              # a, b, c, c, b, a
            ms[r].append(cs.cuda_ms(
                lambda i: call(libs[r], q, *pools[i], table, lens), 8, 200))
        print(f"{what} q {(B, H, HD)} over {KH} KV heads, {nblk} pages x "
              f"{lm.PAGE_SIZE}, length {length} bf16: " + "; ".join(
                  f"rows <= {r or 'default'} {plan(libs[r], nblk, H // KH)}: "
                  f"{np.mean(t):.4f} ms ({', '.join(f'{x:.4f}' for x in t)}"
                  f"), max abs err vs plain "
                  f"{float((outs[r].float() - ref.float()).abs().max()):.3e}"
                  f", bits equal to the default's "
                  f"{torch.equal(outs[r], outs[0])}"
                  for r, t in ms.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
