"""Plain PyTorch version of the MoE slot kernel: the JAX package's formula
(``repro/models/moe.py:116-119``), a one-hot of each slot's expert and an
exclusive cumsum over the group's slots, and what follows from the
position. It is the CPU route of ``repro_torch::moe_slots`` and what the
kernel is held to, bit for bit."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def moe_slots_ref(eid: torch.Tensor, n_experts: int, capacity: int):
    """eid (BG, N) int64, each (token, k) slot's expert in its group,
    token-major. Returns (slot, keep, dest, kept): slot (BG, N) int64
    ``eid * C + min(pos, C - 1)``, keep (BG, N) bool ``pos < C``, dest
    (BG, N) int64 ``where(keep, slot, Ee * C) + bg * (Ee * C + 1)`` (the
    row of the group's (Ee * C + 1)-row scatter buffer, the last row taking
    the dropped slots) and kept (BG, Ee) int32, each expert's kept slots;
    pos is the number of earlier slots of the group with the same
    expert."""
    BG = eid.shape[0]
    C = capacity
    onehot = F.one_hot(eid, n_experts)                     # (BG,N,Ee)
    pos = ((torch.cumsum(onehot, dim=1) - onehot) * onehot).sum(-1)
    keep = pos < C
    slot = eid * C + torch.clamp_max(pos, C - 1)
    rows = n_experts * C + 1
    dest = torch.where(keep, slot, n_experts * C) \
        + torch.arange(BG, device=eid.device).reshape(BG, 1) * rows
    kept = (onehot * keep[..., None]).sum(1).to(torch.int32)
    return slot, keep, dest, kept
