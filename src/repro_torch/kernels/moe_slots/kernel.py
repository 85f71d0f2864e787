"""The MoE dispatch's slot positions — the hand-written CUDA kernel's
wrapper.

The kernel is ``csrc/moe_slots.cu`` (it replaces the one-hot and exclusive
cumsum at ``repro/models/moe.py:116-119``); its header says what bounds it
and how it is laid out. This wrapper checks its input, allocates the
outputs (and, when a group spans more than one tile, the tiles'
histograms), launches on the current stream and counts kernel launches in
``moe_slots.launches``: one a call, two when a group spans more than one
tile. The limits on the experts and the capacity are the C entry's, which
returns ``cudaErrorInvalidValue`` outside them. It takes CUDA tensors
only; the plain version is ``ref.moe_slots_ref``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

SOURCE = "moe_slots"
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int64] * 2 + [ctypes.c_int]
             + [ctypes.c_int64, ctypes.c_void_p])


@functools.cache
def tile() -> int:
    """Slots a CTA: a group of N slots spans ceil(N / tile()) tiles, and
    takes two launches when that is more than one."""
    return int(_build.bind(SOURCE, "moe_slots_tile", [])())


def moe_slots(eid, n_experts: int, capacity: int):
    """eid (BG, N) int64 on the card. Returns (slot, keep, dest, kept) as
    ``ref.moe_slots_ref`` does: (BG, N) int64, bool, int64 and (BG, Ee)
    int32."""
    if not eid.is_cuda:
        raise ValueError("moe_slots launches a CUDA kernel: eid must be on a "
                         "CUDA device, got " + str(eid.device))
    if eid.dtype != torch.int64 or eid.ndim != 2:
        raise TypeError(f"moe_slots takes eid (BG, N) int64, got "
                        f"{tuple(eid.shape)} {eid.dtype}")
    eid = eid.contiguous()
    BG, N = eid.shape
    dev = eid.device
    slot = torch.empty((BG, N), dtype=torch.int64, device=dev)
    keep = torch.empty((BG, N), dtype=torch.bool, device=dev)
    dest = torch.empty((BG, N), dtype=torch.int64, device=dev)
    if BG == 0 or N == 0:
        return slot, keep, dest, torch.zeros((BG, n_experts),
                                             dtype=torch.int32, device=dev)
    kept = torch.empty((BG, n_experts), dtype=torch.int32, device=dev)
    tiles = -(-N // tile())
    hist = torch.empty((BG * (tiles - 1) * n_experts,), dtype=torch.int32,
                       device=dev) if tiles > 1 else None
    fn = _build.bind(SOURCE, "moe_slots", _ARGTYPES)
    err = fn(eid.data_ptr(), slot.data_ptr(), keep.data_ptr(),
             dest.data_ptr(), kept.data_ptr(),
             hist.data_ptr() if hist is not None else None, BG, N,
             n_experts, capacity, _build.stream_handle(dev))
    _build.check(SOURCE, "moe_slots", err)
    moe_slots.launches += 1 + (tiles > 1)
    return slot, keep, dest, kept


moe_slots.launches = 0
