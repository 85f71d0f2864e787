"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exports plain C entry points (one per dtype) that
take device pointers, strides and a stream and return the ``cudaError_t``
of the launch. At first use the source is compiled with ``nvcc`` for
``sm_90a`` into ``build/repro_torch/`` at the repository root (listed in
``.gitignore``), under a name keyed by a hash of the source, the headers
it includes (``csrc/hopper.cuh``, ``csrc/mma_sync.cuh``) and the flags,
and loaded with ``ctypes``. Nothing is compiled or loaded at import time,
so the CPU tests import every module without a CUDA toolkit.

A failed build, a missing ``nvcc`` or a nonzero return from a launch
raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
from typing import Dict, Iterable

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("flash_fwd", "flash_bwd", "paged_attn", "ssd_chunk", "ssd_bwd",
           "moe_slots", "adamw")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: dict = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the CUDA kernels cannot be built")
    return path


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def _source_bytes(path: pathlib.Path, seen: set) -> bytes:
    """``path``'s bytes, then those of every header it includes with a
    quoted ``#include`` (found beside the including file), recursively."""
    seen.add(path)
    src = path.read_bytes()
    parts = [src]
    for inc in _INCLUDE.findall(src):
        header = path.parent / inc.decode()
        if header not in seen:
            parts.append(_source_bytes(header, seen))
    return b"".join(parts)


def lib_path(name: str) -> pathlib.Path:
    """Where ``csrc/<name>.cu`` is built: keyed by a hash of the source,
    the headers it includes and the flags, so an edit to any of them
    builds anew."""
    src = _source_bytes(CSRC / f"{name}.cu", set())
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()) \
        .hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every source in ``names`` that is not built yet, one
    ``nvcc`` process per source, all started together. Returns name ->
    the compiler's ``-Xptxas -v`` report (registers, shared memory,
    spills), also kept beside the library as ``<lib>.log``."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        out.with_name(out.name + ".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    reports = {}
    for name in names:
        log = lib_path(name).with_name(lib_path(name).name + ".log")
        reports[name] = log.read_text() if log.exists() else ""
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            err_fn = getattr(lib, f"{name}_error_string")
            err_fn.argtypes = [ctypes.c_int]
            err_fn.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def bind(name: str, symbol: str, argtypes):
    """``symbol`` of ``csrc/<name>.cu`` with its ``argtypes`` set (pointers
    and the stream as ``c_void_p``: ctypes would cut them to 32 bits)."""
    key = (name, symbol)
    fn = _FNS.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FNS[key] = fn
    return fn


def check(name: str, symbol: str, err: int) -> None:
    if err != 0:
        msg = getattr(load(name), f"{name}_error_string")(err)
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err} "
                           f"({msg.decode() if msg else '?'})")


def stream_handle(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
