"""AdamW's gradient norm and update as the torch ops
``repro_torch::adamw_sumsq`` (the gradients' squares summed into
partials), ``repro_torch::adamw_norm`` (the partials finished into the norm
and the clipping factor) and ``repro_torch::adamw_update_``
(``kernels.kernel_op``): the CUDA kernels on CUDA tensors, the plain
version on CPU tensors, on a fake tensor (a dry run's trace) the output
shapes, and for the update nothing, which declares the parameters and
both moments mutated. The partials of the ranks of a mesh may be summed
between the two norm ops. Elementwise work: no FLOPs are counted; the dry
run charges their bytes (``roofline.work``)."""

from __future__ import annotations

import torch

from repro_torch.kernels import kernel_op, reject_dtensor
from repro_torch.kernels.adamw import kernel as _kernel
from repro_torch.kernels.adamw.ref import (adamw_norm_ref, adamw_sumsq_ref,
                                           adamw_update_ref)


def _sumsq_route(grads: list[torch.Tensor]) -> torch.Tensor:
    if grads[0].device.type == "cpu":
        return adamw_sumsq_ref(grads)
    return _kernel.adamw_sumsq(grads)


def _sumsq_fake(grads):
    g = grads[0]
    if g.device.type == "cpu":
        return g.new_empty((len(grads),), dtype=torch.float32)
    return g.new_empty((_kernel.NORM_BLOCKS,), dtype=torch.float64)


def _norm_route(partial: torch.Tensor, clip_norm: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    if partial.device.type == "cpu":
        return adamw_norm_ref(partial, clip_norm)
    return _kernel.adamw_norm(partial, clip_norm)


def _norm_fake(partial, clip_norm):
    return (partial.new_empty((), dtype=torch.float32),
            partial.new_empty((), dtype=torch.float32))


def _update_route(params: list[torch.Tensor], grads: list[torch.Tensor],
                  m: list[torch.Tensor], v: list[torch.Tensor],
                  scale: torch.Tensor, lr: torch.Tensor, bc1: torch.Tensor,
                  bc2: torch.Tensor, b1: float, b2: float, eps: float,
                  weight_decay: float) -> None:
    fn = adamw_update_ref if params[0].device.type == "cpu" \
        else _kernel.adamw_update_
    fn(params, grads, m, v, scale, lr, bc1, bc2, b1, b2, eps, weight_decay)


def _update_fake(params, grads, m, v, scale, lr, bc1, bc2, b1, b2, eps,
                 weight_decay):
    return None


sumsq_op = kernel_op("adamw_sumsq", _sumsq_route, _sumsq_fake)
norm_op = kernel_op("adamw_norm", _norm_route, _norm_fake)
update_op = kernel_op("adamw_update_", _update_route, _update_fake,
                      mutates_args=("params", "m", "v"))


def adamw_sumsq(grads) -> torch.Tensor:
    """grads: plain tensors of one device (fp32 or bf16 on the card).
    Returns the partials of their squares' sum (on the card
    ``NORM_BLOCKS`` fp64, on the CPU each leaf's fp32 sum), which
    ``adamw_norm`` finishes. A DTensor raises ``TypeError``."""
    grads = list(grads)
    if not grads:
        raise ValueError("adamw_sumsq takes at least one gradient")
    reject_dtensor(*grads)
    return sumsq_op(grads)


def adamw_norm(partial, clip_norm: float):
    """(gnorm, scale), 0-d fp32 on the partials' device: the global L2
    norm whose squares ``adamw_sumsq`` summed into ``partial`` and min(1,
    clip_norm / max(gnorm, 1e-9))."""
    reject_dtensor(partial)
    return norm_op(partial, float(clip_norm))


def adamw_update_(params, grads, m, v, scale, lr, bc1, bc2, *, b1: float,
                  b2: float, eps: float, weight_decay: float) -> None:
    """Update ``params`` and the moments ``m``, ``v`` (lists of leaves) IN
    PLACE: the gradients scaled by ``scale``, learning rate ``lr``, bias
    corrections ``bc1``, ``bc2`` (0-d fp32 tensors on the leaves' device),
    weight decay on leaves of two or more dims. A DTensor raises
    ``TypeError``."""
    params, grads, m, v = list(params), list(grads), list(m), list(v)
    if not params:
        raise ValueError("adamw_update_ takes at least one parameter")
    reject_dtensor(*params, *grads, *m, *v, scale, lr, bc1, bc2)
    update_op(params, grads, m, v, scale, lr, bc1, bc2, float(b1), float(b2),
              float(eps), float(weight_decay))
