"""Flash attention forward — the hand-written CUDA kernel's wrapper.

The kernel is ``csrc/flash_fwd.cu`` (it replaces the Pallas TPU kernel
``repro/kernels/flash_attention/kernel.py:flash_attention_fwd``); its
header says what bounds it and how it is laid out. This wrapper checks
its inputs, allocates the output, launches on the current stream and
counts launches in ``flash_attention_fwd.launches``. It takes CUDA
tensors only; the plain version is ``ref.flash_attention_ref``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

SOURCE = "flash_fwd"
_SYMBOLS = {torch.bfloat16: "flash_fwd_bf16", torch.float32: "flash_fwd_f32"}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_int64] * 12
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
HEAD_DIMS = (32, 64, 80, 128)


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        scale: float | None = None):
    """q: (B, S, H, hd); k/v: (B, Sk, KH, hd), H % KH == 0, all CUDA
    tensors of one dtype (bf16 or fp32) with a contiguous last dim.
    Returns a new contiguous (B, S, H, hd) tensor in q's dtype."""
    B, S, H, hd = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    for t in (q, k, v):
        if not t.is_cuda:
            raise ValueError("flash_attention_fwd launches a CUDA kernel: "
                             "got a tensor on " + str(t.device))
        if t.dtype != q.dtype or t.dtype not in _SYMBOLS:
            raise TypeError(f"flash kernel takes bf16 or fp32 q/k/v of one "
                            f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
        if t.stride(-1) != 1:
            raise ValueError("flash kernel needs a contiguous head dim")
    if k.shape != (B, Sk, KH, hd) or v.shape != k.shape or H % KH:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash kernel supports hd in {HEAD_DIMS}, got {hd}")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])
            for t in (q, k, v)):
        raise ValueError("the bf16 flash kernel loads with TMA: q/k/v "
                         "need 16-byte aligned pointers and strides")
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    o = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    symbol = _SYMBOLS[q.dtype]
    fn = _build.bind(SOURCE, symbol, _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             B, S, Sk, H, KH, hd,
             q.stride(0), q.stride(1), q.stride(2),
             k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2),
             o.stride(0), o.stride(1), o.stride(2),
             float(scale), int(bool(causal)), int(window),
             _build.stream_handle(q.device))
    _build.check(SOURCE, symbol, err)
    flash_attention_fwd.launches += 1
    return o


flash_attention_fwd.launches = 0


def plan(hd: int) -> dict:
    """The bf16 kernel's CTA at this head_dim: threads, shared-memory
    bytes and CTAs an SM holds. Builds the kernel if needed."""
    fn = _build.bind(SOURCE, "flash_fwd_bf16_plan",
                     [ctypes.c_int, ctypes.c_void_p])
    out = (ctypes.c_int * 3)()
    err = fn(hd, ctypes.cast(out, ctypes.c_void_p))
    _build.check(SOURCE, "flash_fwd_bf16_plan", err)
    return dict(zip(("threads", "smem_bytes", "ctas_per_sm"), out))
