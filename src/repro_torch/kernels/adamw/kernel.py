"""AdamW's gradient norm and update — the hand-written CUDA kernels'
wrappers.

The kernels are ``csrc/adamw.cu`` (the port's AdamW had no TPU kernel: the
JAX package computes it in jnp, ``repro/optim/adamw.py:56-62``); its header
says what bounds them and how they are laid out. The wrappers check their
inputs, group the leaves by dtype (one table of up to ``table_leaves()``
leaves a launch), allocate the norm's partials and outputs, launch on the
current stream without a synchronise and count kernel launches:
``adamw_sumsq.launches`` one a table, ``adamw_norm.launches`` one,
``adamw_update_.launches`` one a table. A leaf of no elements is left out.
They take CUDA tensors only; the plain versions are in ``ref``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

SOURCE = "adamw"
DTYPES = (torch.float32, torch.bfloat16)
NORM_BLOCKS = 528               # the norm's fixed grid: its fp64 partials
_SUMSQ = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
          ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_FINISH = [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
           ctypes.c_void_p, ctypes.c_void_p]
_UPDATE = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
           + [ctypes.c_float] * 5 + [ctypes.c_void_p])


@functools.cache
def table_leaves() -> int:
    """Leaves a launch takes: more leaves of one dtype pair take more."""
    return int(_build.bind(SOURCE, "adamw_table_leaves", [])())


def _check(name, t, device, dtypes=DTYPES):
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"adamw launches a CUDA kernel: {name} must be a "
                         f"CUDA tensor, got "
                         f"{getattr(t, 'device', type(t).__name__)}")
    if t.device != device:
        raise ValueError(f"adamw: {name} is on {t.device}, not {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"adamw: {name} is {t.dtype}; it takes "
                        f"{', '.join(map(str, dtypes))}")


def _scalar(name, t, device):
    _check(name, t, device, (torch.float32,))
    if t.numel() != 1:
        raise ValueError(f"adamw: {name} must hold one value, got "
                         f"{tuple(t.shape)}")
    return t.contiguous()


def _groups(leaves, key):
    """Leaves of at least one element by ``key(leaf)``, in first-seen
    order."""
    out: dict = {}
    for leaf in leaves:
        if leaf[0].numel():
            out.setdefault(key(leaf), []).append(leaf)
    return out


def _i64(values):
    return (ctypes.c_int64 * max(len(values), 1))(*values)


def adamw_sumsq(grads) -> torch.Tensor:
    """grads: CUDA tensors, fp32 or bf16, of one device. Returns their
    squares' sum as ``NORM_BLOCKS`` fp64 partials on the device (the same
    bits on every call), which ``adamw_norm`` finishes; partials of
    several sets of leaves (the shards of a mesh's ranks) may be added
    elementwise first."""
    if not grads:
        raise ValueError("adamw_sumsq takes at least one gradient")
    dev = grads[0].device
    for i, g in enumerate(grads):
        _check(f"grads[{i}]", g, dev)
    partial = torch.empty((NORM_BLOCKS,), dtype=torch.float64, device=dev)
    groups = _groups([(g.contiguous(),) for g in grads],
                     lambda leaf: leaf[0].dtype)
    if not groups:
        return partial.zero_()
    stream = _build.stream_handle(dev)
    fn = _build.bind(SOURCE, "adamw_sumsq", _SUMSQ)
    for i, (dtype, leaves) in enumerate(groups.items()):
        # the arrays stay referenced until the call returns
        ptrs, numel = (_i64([g.data_ptr() for (g,) in leaves]),
                       _i64([g.numel() for (g,) in leaves]))
        err = fn(ctypes.addressof(ptrs), ctypes.addressof(numel),
                 len(leaves), int(dtype == torch.bfloat16),
                 partial.data_ptr(), NORM_BLOCKS, int(i > 0), stream)
        _build.check(SOURCE, "adamw_sumsq", err)
        adamw_sumsq.launches += -(-len(leaves) // table_leaves())
    return partial


def adamw_norm(partial: torch.Tensor, clip_norm: float):
    """partial: ``adamw_sumsq``'s fp64 partials on the card. Returns
    (gnorm, scale), 0-d fp32 on the device: the square root of their sum
    and min(1, clip_norm / max(gnorm, 1e-9)), as ``ref.adamw_norm_ref``
    gives them to within the order of the sum."""
    _check("partial", partial, partial.device, (torch.float64,))
    partial = partial.contiguous()
    dev = partial.device
    gnorm = torch.empty((), dtype=torch.float32, device=dev)
    scale = torch.empty((), dtype=torch.float32, device=dev)
    fin = _build.bind(SOURCE, "adamw_sumsq_finish", _FINISH)
    err = fin(partial.data_ptr(), partial.numel(), float(clip_norm),
              gnorm.data_ptr(), scale.data_ptr(), _build.stream_handle(dev))
    _build.check(SOURCE, "adamw_sumsq_finish", err)
    adamw_norm.launches += 1
    return gnorm, scale


def adamw_update_(params, grads, m, v, scale, lr, bc1, bc2, b1: float,
                  b2: float, eps: float, weight_decay: float) -> None:
    """Update each leaf of ``params`` (contiguous CUDA tensors, fp32 or
    bf16) and its moments ``m`` and ``v`` (contiguous fp32, its size) IN
    PLACE from its gradient (fp32 or bf16, its size) as
    ``ref.adamw_update_ref`` does, bit for bit; ``scale``, ``lr``, ``bc1``
    and ``bc2`` are one-element fp32 tensors on the device, read there.
    Weight decay only on leaves of two or more dims."""
    if not (len(params) == len(grads) == len(m) == len(v)):
        raise ValueError(f"adamw_update_: {len(params)} params, {len(grads)} "
                         f"grads, {len(m)} m, {len(v)} v")
    if not params:
        return
    dev = params[0].device
    leaves = []
    for i, (p, g, m_, v_) in enumerate(zip(params, grads, m, v)):
        _check(f"params[{i}]", p, dev)
        _check(f"grads[{i}]", g, dev)
        _check(f"m[{i}]", m_, dev, (torch.float32,))
        _check(f"v[{i}]", v_, dev, (torch.float32,))
        if not (p.numel() == g.numel() == m_.numel() == v_.numel()):
            raise ValueError(f"adamw_update_: leaf {i} has {p.numel()} "
                             f"params, {g.numel()} grads, {m_.numel()} m, "
                             f"{v_.numel()} v")
        for name, t in (("params", p), ("m", m_), ("v", v_)):
            if not t.is_contiguous():
                raise ValueError(f"adamw_update_: {name}[{i}] is updated in "
                                 f"place and must be contiguous")
        leaves.append((p, g.contiguous(), m_, v_,
                       weight_decay if p.ndim >= 2 else 0.0))
    scalars = [_scalar(n, t, dev).data_ptr() for n, t in
               (("scale", scale), ("lr", lr), ("bc1", bc1), ("bc2", bc2))]
    stream = _build.stream_handle(dev)
    fn = _build.bind(SOURCE, "adamw_update", _UPDATE)
    for (pdt, gdt), group in _groups(
            leaves, lambda leaf: (leaf[0].dtype, leaf[1].dtype)).items():
        ptrs = _i64([t.data_ptr() for leaf in group for t in leaf[:4]])
        numel = _i64([leaf[0].numel() for leaf in group])
        decay = (ctypes.c_float * len(group))(*[leaf[4] for leaf in group])
        err = fn(ctypes.addressof(ptrs), ctypes.addressof(numel),
                 ctypes.addressof(decay), len(group),
                 int(pdt == torch.bfloat16), int(gdt == torch.bfloat16),
                 *scalars, b1, 1 - b1, b2, 1 - b2, eps, stream)
        _build.check(SOURCE, "adamw_update", err)
        adamw_update_.launches += -(-len(group) // table_leaves())


adamw_sumsq.launches = 0
adamw_norm.launches = 0
adamw_update_.launches = 0
