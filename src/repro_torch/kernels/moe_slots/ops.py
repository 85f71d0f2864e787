"""The MoE dispatch's slot positions as the torch op
``repro_torch::moe_slots`` (``kernels.kernel_op``): the CUDA kernel on a
CUDA tensor, the plain version (the JAX package's one-hot and cumsum) on
a CPU tensor, the output shapes alone on a fake tensor (a dry run's
trace). Its outputs are integers: it has no gradient and no FLOPs."""

from __future__ import annotations

import torch

from repro_torch.kernels import kernel_op, reject_dtensor
from repro_torch.kernels.moe_slots.kernel import moe_slots as _kernel
from repro_torch.kernels.moe_slots.ref import moe_slots_ref


def _route(eid: torch.Tensor, n_experts: int, capacity: int
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    if eid.device.type == "cpu":
        return moe_slots_ref(eid, n_experts, capacity)
    return _kernel(eid, n_experts, capacity)


def _fake(eid, n_experts, capacity):
    BG, N = eid.shape
    return (eid.new_empty((BG, N)), eid.new_empty((BG, N), dtype=torch.bool),
            eid.new_empty((BG, N)),
            eid.new_empty((BG, n_experts), dtype=torch.int32))


slots_op = kernel_op("moe_slots", _route, _fake)


def moe_slots(eid, n_experts: int, capacity: int):
    """eid (BG, N) int64, each (token, k) slot's expert in its group,
    token-major; ``n_experts`` the experts a group dispatches to (Ee) and
    ``capacity`` the slots an expert takes (C). Returns (slot, keep, dest,
    kept): (BG, N) int64, bool and int64, and (BG, Ee) int32, as
    ``ref.moe_slots_ref`` gives them. A DTensor raises ``TypeError``."""
    reject_dtensor(eid)
    return slots_op(eid, int(n_experts), int(capacity))
