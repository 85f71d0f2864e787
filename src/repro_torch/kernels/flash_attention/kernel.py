"""Flash attention forward and backward — the hand-written CUDA kernels'
wrappers.

The forward is ``csrc/flash_fwd.cu`` (it replaces the Pallas TPU kernel
``repro/kernels/flash_attention/kernel.py:flash_attention_fwd``), the
backward ``csrc/flash_bwd.cu`` (it replaces the jnp block-recompute
backward of the custom VJP at ``repro/models/attention.py:211``; the JAX
package has no Pallas backward). Each source's header says what bounds
it and how it is laid out. The wrappers check their inputs, allocate the
outputs, launch on the current stream and count launches in
``flash_attention_fwd.launches`` / ``flash_attention_bwd.launches``. They
take CUDA tensors only; the plain versions are in ``ref.py``
(``reference_attention``, ``flash_attention_fwd_ref`` with its lse,
``flash_attention_bwd_ref``).

Head dims: q, k and v of one head dim in ``HEAD_DIMS``, or MLA's pair
(``MLA_DIMS``: q/k 192, v 128, deepseek-v2-lite's prefill and training),
in both directions.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

SOURCE = "flash_fwd"
_SYMBOLS = {torch.bfloat16: "flash_fwd_bf16", torch.float32: "flash_fwd_f32"}
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
             + [ctypes.c_int64] * 12
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
BWD_SOURCE = "flash_bwd"
_BWD_SYMBOLS = {torch.bfloat16: "flash_bwd_bf16",
                torch.float32: "flash_bwd_f32"}
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                 + [ctypes.c_int64] * 15
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p])
HEAD_DIMS = (32, 64, 80, 128)
MLA_DIMS = (192, 128)          # (q/k head dim, v head dim)


def _check_qkv(name, q, k, v, extra=(), pairs=()):
    """q: (B, S, H, hd) and ``extra`` like it; k: (B, Sk, KH, hd), v:
    (B, Sk, KH, hd_v), H % KH == 0, with hd_v == hd in ``HEAD_DIMS`` or
    (hd, hd_v) in ``pairs``; all CUDA tensors of one dtype (bf16 or fp32)
    on one device with a contiguous last dim."""
    B, S, H, hd = q.shape
    Sk, KH, hdv = k.shape[1], k.shape[2], v.shape[-1]
    for t in (q, k, v, *extra):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} launches a CUDA kernel: every input "
                             f"must be on one CUDA device, got {t.device}")
        if t.dtype != q.dtype or t.dtype not in _SYMBOLS:
            raise TypeError(f"flash kernels take bf16 or fp32 inputs of one "
                            f"dtype, got {q.dtype}/{t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError("flash kernels need a contiguous head dim")
    if k.shape != (B, Sk, KH, hd) or v.shape != (B, Sk, KH, hdv) \
            or H % KH or any(t.shape != q.shape for t in extra):
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} "
                         f"{[tuple(t.shape) for t in extra]}")
    if not ((hd == hdv and hd in HEAD_DIMS) or (hd, hdv) in pairs):
        raise ValueError(f"{name} takes hd in {HEAD_DIMS} for q, k and v"
                         f"{f' or (q/k, v) in {pairs}' if pairs else ''}, "
                         f"got q/k {hd}, v {hdv}")


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        scale: float | None = None, with_lse: bool = False):
    """q: (B, S, H, hd); k: (B, Sk, KH, hd), v: (B, Sk, KH, hd_v),
    H % KH == 0, hd_v == hd or (hd, hd_v) == ``MLA_DIMS``; all CUDA
    tensors of one dtype (bf16 or fp32) with a contiguous last dim.
    Returns a new contiguous (B, S, H, hd_v) tensor in q's dtype and, with
    ``with_lse``, the (B, H, S) fp32 log-sum-exp of the scaled scores
    that the backward reads (without it the kernel writes none)."""
    B, S, H, hd = q.shape
    Sk, KH, hdv = k.shape[1], k.shape[2], v.shape[-1]
    _check_qkv("flash_attention_fwd", q, k, v, pairs=(MLA_DIMS,))
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3])
            for t in (q, k, v)):
        raise ValueError("the bf16 flash kernel loads with TMA: q/k/v "
                         "need 16-byte aligned pointers and strides")
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    o = torch.empty((B, S, H, hdv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if with_lse else None
    symbol = _SYMBOLS[q.dtype]
    fn = _build.bind(SOURCE, symbol, _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr() if with_lse else None,
             B, S, Sk, H, KH, hd, hdv,
             q.stride(0), q.stride(1), q.stride(2),
             k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2),
             o.stride(0), o.stride(1), o.stride(2),
             float(scale), int(bool(causal)), int(window),
             _build.stream_handle(q.device))
    _build.check(SOURCE, symbol, err)
    flash_attention_fwd.launches += 1
    return (o, lse) if with_lse else o


flash_attention_fwd.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, scale: float | None = None):
    """The gradient of ``flash_attention_fwd``: q (B, S, H, hd), k
    (B, Sk, KH, hd), v (B, Sk, KH, hd_v), o and do (B, S, H, hd_v) as the
    forward takes and gives them (hd_v == hd, or (hd, hd_v) ==
    ``MLA_DIMS``), read through their strides (in bf16, one that is not
    16-byte aligned is copied first); lse (B, H, S) fp32 from
    ``flash_attention_fwd(..., with_lse=True)``. Returns new contiguous
    (dq, dk, dv) in the inputs' dtype, shaped as q, k and v; dk/dv hold
    the sum over the G query heads of each KV head. One
    call runs three kernels of ``csrc/flash_bwd.cu`` in order on the
    current stream (D = rowsum(do·o), then dK/dV, then dQ) and counts one
    launch. Deterministic: no atomics, a fixed order of every sum."""
    B, S, H, hd = q.shape
    Sk, KH, hdv = k.shape[1], k.shape[2], v.shape[-1]
    _check_qkv("flash_attention_bwd", q, k, v, pairs=(MLA_DIMS,))
    for name, t in (("o", o), ("do", do)):
        if t.shape != (B, S, H, hdv) or t.dtype != q.dtype \
                or t.device != q.device or t.stride(-1) != 1:
            raise ValueError(f"{name} must be a ({B}, {S}, {H}, {hdv}) "
                             f"{q.dtype} tensor on {q.device} with a "
                             f"contiguous last dim, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    if q.dtype == torch.bfloat16:
        # TMA reads q, k, v and do, the pre-pass o and do 16 bytes at a
        # time: an input that is not 16-byte aligned is copied contiguous
        # first
        q, k, v, o, do = (t if t.data_ptr() % 16 == 0 and all(
            st % 8 == 0 for st in t.stride()[:3]) else
            t.clone(memory_format=torch.contiguous_format)
            for t in (q, k, v, o, do))
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, S) or \
            not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse must be a contiguous (B, H, S) fp32 tensor "
                         f"on {q.device}, got {tuple(lse.shape)} "
                         f"{lse.dtype} on {lse.device}")
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    dq = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Sk, KH, hd), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, Sk, KH, hdv), dtype=v.dtype, device=q.device)
    # the pre-pass's scratch: D and (bf16) lse·log2 e, each (B, H, S)
    # padded to whole 64-row tiles, so a tile's rows are one aligned copy
    s_pad = -(-S // 64) * 64
    d_scratch = torch.empty((2, B, H, s_pad), dtype=torch.float32,
                            device=q.device)
    symbol = _BWD_SYMBOLS[q.dtype]
    fn = _build.bind(BWD_SOURCE, symbol, _BWD_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), d_scratch.data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             B, S, Sk, H, KH, hd, hdv,
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *o.stride()[:3], *do.stride()[:3],
             float(scale), int(bool(causal)), int(window),
             _build.stream_handle(q.device))
    _build.check(BWD_SOURCE, symbol, err)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


def plan(hd: int, hd_v: int | None = None) -> dict:
    """The bf16 kernel's CTA at this head_dim (q/k ``hd``, v ``hd_v``,
    by default ``hd``): threads, shared-memory bytes and CTAs an SM holds.
    Builds the kernel if needed."""
    fn = _build.bind(SOURCE, "flash_fwd_bf16_plan",
                     [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    out = (ctypes.c_int * 3)()
    err = fn(hd, hd if hd_v is None else hd_v,
             ctypes.cast(out, ctypes.c_void_p))
    _build.check(SOURCE, "flash_fwd_bf16_plan", err)
    return dict(zip(("threads", "smem_bytes", "ctas_per_sm"), out))


def plan_bwd(hd: int, hd_v: int | None = None) -> dict:
    """The bf16 backward's CTAs at this head_dim (q/k ``hd``, v ``hd_v``,
    by default ``hd``): for its dK/dV and its dQ kernel, threads,
    shared-memory bytes, CTAs an SM holds, registers a thread at launch
    and local-memory (spill) bytes a thread (``cudaFuncGetAttributes``;
    the dK/dV consumers raise theirs to 240 with ``setmaxnreg``). Builds
    the kernel if needed."""
    fn = _build.bind(BWD_SOURCE, "flash_bwd_bf16_plan",
                     [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    out = (ctypes.c_int * 10)()
    err = fn(hd, hd if hd_v is None else hd_v,
             ctypes.cast(out, ctypes.c_void_p))
    _build.check(BWD_SOURCE, "flash_bwd_bf16_plan", err)
    keys = ("threads", "smem_bytes", "ctas_per_sm", "registers",
            "spill_bytes")
    return {"dkdv": dict(zip(keys, out[:5])), "dq": dict(zip(keys, out[5:]))}


def tile_kinds(S: int, Sk: int, q_tile: int, k_tile: int, causal: bool,
               window: int) -> torch.Tensor:
    """The tile rule as compiled into the bf16 backward kernels
    (``tile_kind`` in ``csrc/flash_bwd.cu``, run on the host): an (nq, nk)
    int8 CPU tensor to hold against ``ref.tile_kinds``. Builds the kernel
    if needed; needs no card."""
    fn = _build.bind(BWD_SOURCE, "flash_bwd_tile_kinds",
                     [ctypes.c_int] * 6 + [ctypes.c_void_p])
    out = torch.empty((-(-S // q_tile), -(-Sk // k_tile)), dtype=torch.int8)
    err = fn(S, Sk, q_tile, k_tile, int(bool(causal)), int(window),
             out.data_ptr())
    _build.check(BWD_SOURCE, "flash_bwd_tile_kinds", err)
    return out
