"""Plain PyTorch version of the paged decode kernel: gather the pages into a
dense cache, run decode attention."""

from __future__ import annotations

import torch

from repro_torch.models import attention as _attn


def paged_attention_ref(q, k_pages, v_pages, page_table, lengths, *,
                        scale=None):
    B, H, hd = q.shape
    n_pages, page_sz, KH, _ = k_pages.shape
    nblk = page_table.shape[1]
    idx = page_table.long()
    k = k_pages[idx].reshape(B, nblk * page_sz, KH, hd)
    v = v_pages[idx].reshape(B, nblk * page_sz, KH, hd)
    lens = lengths.tolist()
    outs = [_attn.decode_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                   lens[b] - 1, scale=scale)
            for b in range(B)]
    return torch.cat(outs, dim=0)
