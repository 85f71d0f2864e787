"""Paged decode attention: the CUDA kernel on CUDA tensors, the plain
version on CPU tensors (and on nothing else).

Decode is never differentiated, and the kernel has no backward: a call on
CUDA tensors that needs a gradient raises ``NotImplementedError`` rather
than return a tensor that would drop it."""

from __future__ import annotations

from repro_torch.kernels import needs_grad, reject_dtensor
from repro_torch.kernels.paged_attn.kernel import paged_attention as _kernel
from repro_torch.kernels.paged_attn.ref import paged_attention_ref


def paged_attention(q, k_pages, v_pages, page_table, lengths, *,
                    scale: float | None = None):
    """q: (B, H, hd); pools: (n_pages, page_sz, KH, hd); page_table:
    (B, nblk) int32; lengths: (B,) int32. Returns (B, H, hd). A DTensor
    raises ``TypeError``."""
    reject_dtensor(q, k_pages, v_pages, page_table, lengths)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, page_table, lengths,
                                   scale=scale)
    if needs_grad(q, k_pages, v_pages):
        raise NotImplementedError("the paged decode kernel has no backward: "
                                  "decode attention is not differentiable "
                                  "on the card")
    return _kernel(q, k_pages, v_pages, page_table, lengths, scale=scale)
