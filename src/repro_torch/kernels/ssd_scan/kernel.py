"""Mamba2 SSD intra-chunk step and its gradient — the hand-written CUDA
kernels' wrappers.

The forward is ``csrc/ssd_chunk.cu`` (it replaces the Pallas TPU kernel
``repro/kernels/ssd_scan/kernel.py:ssd_chunk_call``), the backward
``csrc/ssd_bwd.cu`` (it replaces the gradient ``jax.grad`` takes through
the jnp ``ssd_chunked`` at ``repro/models/mamba.py:76``; the JAX package
has no Pallas backward). Each source's header says what bounds it and how
it is laid out. The wrappers check their inputs, allocate the outputs
(and the backward's scratch), launch on the current stream and count
launches in ``ssd_chunk_call.launches`` / ``ssd_chunk_bwd.launches``.
They take CUDA tensors only; the plain versions are ``ref.ssd_chunk_ref``
(with ``ref.ssd_chunk_split_ref``, the split arithmetic of the bf16
tensor-core instance) and ``ref.ssd_chunk_bwd_ref`` (with
``ref.ssd_chunk_bwd_split_ref``, the same for the backward). ``plan``
reports which of the forward's three kernels a call runs and how it is
laid out, ``plan_bwd`` the backward's launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SOURCE = "ssd_chunk"
_SYMBOLS = {torch.bfloat16: "ssd_chunk_bf16", torch.float32: "ssd_chunk_f32"}
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
MAX_HP, MAX_NS = 128, 256     # y accumulators a thread; shared-memory tiles
BWD_SOURCE = "ssd_bwd"
_BWD_SYMBOLS = {torch.bfloat16: "ssd_bwd_bf16", torch.float32: "ssd_bwd_f32"}
_BWD_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
# the backward's tiles: hp and ns a multiple of 4 up to these, cl <= 256
BWD_MAX_HP, BWD_MAX_NS, BWD_MAX_CL = 64, 128, 256
PATHS = ("scalar", "mma", "decode")
_PLAN_KEYS = ("path", "ctas", "threads", "heads_per_cta", "smem_bytes",
              "ctas_per_sm", "registers", "spill_bytes", "sms")


def _check_inputs(name, x, dt, A_log, B_, C_, extra=()):
    B, S, nh, hp = x.shape
    ns = B_.shape[-1]
    for t in (x, dt, A_log, B_, C_, *extra):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} launches a CUDA kernel: every input "
                             f"must be on one CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous inputs")
    if x.dtype not in _SYMBOLS or B_.dtype != x.dtype or C_.dtype != x.dtype:
        raise TypeError(f"SSD kernels take bf16 or fp32 x/B/C of one dtype, "
                        f"got {x.dtype}/{B_.dtype}/{C_.dtype}")
    if dt.dtype != torch.float32 or A_log.dtype != torch.float32:
        raise TypeError(f"SSD kernels take fp32 dt and A_log, got "
                        f"{dt.dtype}/{A_log.dtype}")
    if tuple(dt.shape) != (B, S, nh) or tuple(A_log.shape) != (nh,) \
            or tuple(B_.shape) != (B, S, ns) or C_.shape != B_.shape:
        raise ValueError(f"bad shapes x{tuple(x.shape)} dt{tuple(dt.shape)} "
                         f"A_log{tuple(A_log.shape)} B{tuple(B_.shape)} "
                         f"C{tuple(C_.shape)}")


def ssd_chunk_call(x, dt, A_log, B_, C_, *, chunk: int):
    """x: (B, S, nh, hp); dt: (B, S, nh) fp32; A_log: (nh,) fp32;
    B_/C_: (B, S, ns); x, B_, C_ of one dtype (bf16 or fp32); all
    contiguous CUDA tensors, S a multiple of cl = min(chunk, S).

    Returns the per-chunk pieces, fp32:
      y_diag  (B, nc, cl, nh, hp)
      states  (B, nc, nh, hp, ns)
      exp_cs  (B, nc, cl, nh)
      exp_tot (B, nc, nh)
    """
    B, S, nh, hp = x.shape
    ns = B_.shape[-1]
    _check_inputs("ssd_chunk_call", x, dt, A_log, B_, C_)
    if hp % 4 or hp > MAX_HP or ns > MAX_NS:
        raise ValueError(f"SSD kernel takes hp <= {MAX_HP} (a multiple of 4) "
                         f"and ns <= {MAX_NS}, got hp={hp} ns={ns}")
    cl = min(chunk, S)
    if S % cl:
        raise ValueError(f"S={S} is not a multiple of the chunk {cl}: pad "
                         f"first (ops.ssd does)")
    nc = S // cl
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((B, nc, cl, nh, hp), **f32)
    st = torch.empty((B, nc, nh, hp, ns), **f32)
    ecs = torch.empty((B, nc, cl, nh), **f32)
    etot = torch.empty((B, nc, nh), **f32)
    symbol = _SYMBOLS[x.dtype]
    fn = _build.bind(SOURCE, symbol, _ARGTYPES)
    err = fn(x.data_ptr(), dt.data_ptr(), A_log.data_ptr(), B_.data_ptr(),
             C_.data_ptr(), y.data_ptr(), st.data_ptr(), ecs.data_ptr(),
             etot.data_ptr(), B, S, nh, hp, ns, cl,
             _build.stream_handle(x.device))
    _build.check(SOURCE, symbol, err)
    ssd_chunk_call.launches += 1
    return y, st, ecs, etot


ssd_chunk_call.launches = 0


def ssd_chunk_bwd(x, dt, A_log, B_, C_, dy, dst, decs, detot, *,
                  chunk: int):
    """The gradient of ``ssd_chunk_call``'s pieces: the forward's inputs
    (as ``ssd_chunk_call`` takes them, with hp and ns a multiple of 4, hp
    <= 64, ns <= 128 and cl = min(chunk, S) <= 256) and the four pieces'
    cotangents, contiguous fp32: dy (B, nc, cl, nh, hp), dst (B, nc, nh,
    hp, ns), decs (B, nc, cl, nh), detot (B, nc, nh).

    Returns (dx, ddt, dA_log, dB, dC): dx, dB and dC in x's dtype, ddt
    and dA_log fp32. No atomics: two calls on the same inputs give the
    same bits. bf16 runs the tensor-core kernels (an input that is not on
    16 bytes is copied first), fp32 the FMA kernels; ``plan_bwd`` lists
    the launches."""
    B, S, nh, hp = x.shape
    ns = B_.shape[-1]
    _check_inputs("ssd_chunk_bwd", x, dt, A_log, B_, C_,
                  (dy, dst, decs, detot))
    cl = min(chunk, S)
    if hp % 4 or hp > BWD_MAX_HP or ns % 4 or ns > BWD_MAX_NS \
            or cl > BWD_MAX_CL:
        raise ValueError(f"SSD backward kernel takes hp <= {BWD_MAX_HP} and "
                         f"ns <= {BWD_MAX_NS} (multiples of 4) and chunks "
                         f"<= {BWD_MAX_CL}, got hp={hp} ns={ns} cl={cl}")
    if S % cl:
        raise ValueError(f"S={S} is not a multiple of the chunk {cl}: pad "
                         f"first (ops.ssd does)")
    nc = S // cl
    want = {"dy": (B, nc, cl, nh, hp), "dst": (B, nc, nh, hp, ns),
            "decs": (B, nc, cl, nh), "detot": (B, nc, nh)}
    for (name, shape), t in zip(want.items(), (dy, dst, decs, detot)):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"cotangent {name}: want fp32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if x.dtype == torch.bfloat16:        # 16-byte copies by cp.async
        x, dt, A_log, B_, C_, dy, dst, decs, detot = (
            t if t.data_ptr() % 16 == 0 else t.clone()
            for t in (x, dt, A_log, B_, C_, dy, dst, decs, detot))
    dx = torch.empty_like(x)
    ddt = torch.empty_like(dt)
    dA_log = torch.empty_like(A_log)
    dB = torch.empty_like(B_)
    dC = torch.empty_like(C_)
    ws = _build.bind(BWD_SOURCE, "ssd_bwd_workspace", [ctypes.c_int] * 4)
    nbytes = ws(B, S, nh, cl)
    if nbytes < 0:
        raise ValueError(f"SSD backward kernel: no scratch layout for B={B} "
                         f"S={S} nh={nh} cl={cl} (past 2 GB)")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    symbol = _BWD_SYMBOLS[x.dtype]
    fn = _build.bind(BWD_SOURCE, symbol, _BWD_ARGTYPES)
    err = fn(*(t.data_ptr() for t in (x, dt, A_log, B_, C_, dy, dst, decs,
                                      detot, dx, ddt, dA_log, dB, dC,
                                      scratch)),
             B, S, nh, hp, ns, cl, _build.stream_handle(x.device))
    _build.check(BWD_SOURCE, symbol, err)
    ssd_chunk_bwd.launches += 1
    return dx, ddt, dA_log, dB, dC


ssd_chunk_bwd.launches = 0


BWD_KERNELS = {
    torch.bfloat16: ("ssd_bwd_scan_kernel", "ssd_bwd_mma_head_kernel",
                     "ssd_bwd_dsum_kernel", "ssd_bwd_mma_dbc_kernel",
                     "ssd_bwd_finish_kernel", "ssd_bwd_dalog_kernel"),
    torch.float32: ("ssd_bwd_head_kernel", "ssd_bwd_ds_kernel",
                    "ssd_bwd_dbc_kernel", "ssd_bwd_finish_kernel",
                    "ssd_bwd_dalog_kernel")}
_BWD_PLAN_KEYS = ("ctas", "threads", "smem_bytes", "registers",
                  "spill_bytes", "ctas_per_sm")


def plan_bwd(B: int, S: int, nh: int, hp: int, ns: int, cl: int,
             dtype) -> dict:
    """The launches ``ssd_chunk_bwd`` makes at these shapes: heads a CTA
    of the bf16 head kernel, column splits of its dC/dB kernel, the
    card's SMs, and for each kernel in launch order (``kernels``: name ->
    dict) its CTAs, threads, dynamic shared memory bytes, registers a
    thread, local-memory (spill) bytes a thread (cudaFuncGetAttributes)
    and CTAs resident on an SM. Builds the kernels if needed."""
    fn = _build.bind(BWD_SOURCE, "ssd_bwd_plan", [ctypes.c_int] * 7
                     + [ctypes.c_void_p])
    out = (ctypes.c_int * (4 + 6 * 6))()
    err = fn(B, S, nh, hp, ns, cl, int(dtype == torch.bfloat16),
             ctypes.cast(out, ctypes.c_void_p))
    _build.check(BWD_SOURCE, "ssd_bwd_plan", err)
    names = BWD_KERNELS[dtype]
    assert out[0] == len(names), (out[0], names)
    return {"heads_per_cta": out[1], "column_splits": out[2],
            "sms": out[3],
            "kernels": {name: dict(zip(_BWD_PLAN_KEYS,
                                       out[4 + 6 * k:10 + 6 * k]))
                        for k, name in enumerate(names)}}


def plan(B: int, S: int, nh: int, hp: int, ns: int, cl: int, dtype) -> dict:
    """The launch ``ssd_chunk_call`` makes at these shapes (x, B and C on
    16-byte boundaries, as fresh tensors are): ``path`` ("decode" for
    cl == 1, "mma" for the bf16 tensor-core kernel, else "scalar"), CTAs,
    threads and heads a CTA, dynamic shared memory bytes, CTAs resident
    on an SM, the kernel's registers a thread and local-memory (spill)
    bytes, and the card's SMs. Builds the kernel if needed."""
    fn = _build.bind(SOURCE, "ssd_chunk_plan", [ctypes.c_int] * 7
                     + [ctypes.c_void_p])
    out = (ctypes.c_int * len(_PLAN_KEYS))()
    err = fn(B, S, nh, hp, ns, cl, int(dtype == torch.bfloat16),
             ctypes.cast(out, ctypes.c_void_p))
    _build.check(SOURCE, "ssd_chunk_plan", err)
    res = dict(zip(_PLAN_KEYS, out))
    res["path"] = PATHS[res["path"]]
    return res

