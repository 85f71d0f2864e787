"""Paged decode attention as the torch custom ops
``repro_torch::paged_attention`` and ``repro_torch::paged_attention_lse``
(``kernels.kernel_op``): the CUDA kernel on CUDA tensors, the plain
version on CPU tensors, the output shapes alone on fake tensors (a dry
run's trace), with ``roofline.work``'s FLOPs for ``FlopCounterMode``.

Decode is never differentiated, and the kernel has no backward: a call on
CUDA tensors that needs a gradient raises ``NotImplementedError`` rather
than return a tensor that would drop it (on CPU tensors such a call runs
the plain version, differentiable, outside the op)."""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import kernel_op, needs_grad, reject_dtensor
from repro_torch.kernels.paged_attn.kernel import paged_attention as _kernel
from repro_torch.kernels.paged_attn.ref import paged_attention_ref
from repro_torch.roofline import work


def _route(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
           page_table: torch.Tensor, lengths: torch.Tensor,
           scale: float) -> torch.Tensor:
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, page_table, lengths,
                                   scale=scale)
    return _kernel(q, k_pages, v_pages, page_table, lengths, scale=scale)


def _route_lse(q: torch.Tensor, k_pages: torch.Tensor,
               v_pages: torch.Tensor, page_table: torch.Tensor,
               lengths: torch.Tensor,
               scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, page_table, lengths,
                                   scale=scale, with_lse=True)
    return _kernel(q, k_pages, v_pages, page_table, lengths, scale=scale,
                   with_lse=True)


def _fake(q, k_pages, v_pages, page_table, lengths, scale):
    return q.new_empty(q.shape)


def _fake_lse(q, k_pages, v_pages, page_table, lengths, scale):
    return (q.new_empty(q.shape),
            q.new_empty(q.shape[:2], dtype=torch.float32))


def _flops(q, k_pages, v_pages, page_table, lengths, scale, out_shape=None):
    return work.op_work("paged_attention", (q, k_pages, v_pages,
                                            page_table))[1]


paged_op = kernel_op("paged_attention", _route, _fake, _flops)
paged_lse_op = kernel_op("paged_attention_lse", _route_lse, _fake_lse,
                         _flops)


def paged_attention(q, k_pages, v_pages, page_table, lengths, *,
                    scale: float | None = None, with_lse: bool = False):
    """q: (B, H, hd); pools: (n_pages, page_sz, KH, hd); page_table:
    (B, nblk) int32; lengths: (B,) int32. Returns (B, H, hd) and, with
    ``with_lse``, each row's (B, H) fp32 log-sum-exp (-1e30 for a
    zero-length row). A DTensor raises ``TypeError``."""
    reject_dtensor(q, k_pages, v_pages, page_table, lengths)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if needs_grad(q, k_pages, v_pages):
        if q.device.type == "cpu":
            return paged_attention_ref(q, k_pages, v_pages, page_table,
                                       lengths, scale=scale,
                                       with_lse=with_lse)
        raise NotImplementedError("the paged decode kernel has no backward: "
                                  "decode attention is not differentiable "
                                  "on the card")
    op = paged_lse_op if with_lse else paged_op
    return op(q, k_pages, v_pages, page_table, lengths, float(scale))
