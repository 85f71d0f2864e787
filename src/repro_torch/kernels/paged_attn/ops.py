"""Paged decode attention: the CUDA kernel on CUDA tensors, the plain
version on CPU tensors (and on nothing else)."""

from __future__ import annotations

from repro_torch.kernels.paged_attn.kernel import paged_attention as _kernel
from repro_torch.kernels.paged_attn.ref import paged_attention_ref


def paged_attention(q, k_pages, v_pages, page_table, lengths, *,
                    scale: float | None = None):
    """q: (B, H, hd); pools: (n_pages, page_sz, KH, hd); page_table:
    (B, nblk) int32; lengths: (B,) int32. Returns (B, H, hd)."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, page_table, lengths,
                                   scale=scale)
    return _kernel(q, k_pages, v_pages, page_table, lengths, scale=scale)
