"""Plain PyTorch versions of the paged decode kernel.

``paged_attention_ref`` gathers the pages into a dense cache and runs
decode attention over the whole batch at once, with the mask built from
``lengths`` on the tensors' device (no host sync). It keeps
``decode_attention``'s casts: q is cast to the cache dtype before the
scores and p to the V dtype before the weighted sum.

``paged_attention_split_ref`` mirrors the CUDA kernel's decomposition: the
G query rows of a KV head are cut into ``row_tiles`` tiles of ceil(G /
row_tiles) rows (the last may be shorter), each tile computed on its own
(``kernel.plan`` reports the kernel's); for each tile the logical pages
are cut into ``n_split`` contiguous ranges of
ceil(nblk / n_split) pages (ranges past the end are empty), each range
makes its own (m, l, acc) in fp32, and the ranges are merged in split
order, each weighted by exp(m_s - M). A range whose positions are all
masked is not dropped: with every position masked each weighs 1, which
keeps the zero-length row equal to the mean of V.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _dense(q, k_pages, v_pages, page_table, lengths, scale):
    B, H, hd = q.shape
    _, page_sz, KH, _ = k_pages.shape
    nblk = page_table.shape[1]
    idx = page_table.long()
    k = k_pages[idx].reshape(B, nblk * page_sz, KH, hd)
    v = v_pages[idx].reshape(B, nblk * page_sz, KH, hd)
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, KH, H // KH, hd).to(k.dtype).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * scale
    pos = torch.arange(nblk * page_sz, device=q.device)
    valid = pos[None, :] < lengths.to(q.device).long()[:, None]   # (B, L)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    return s, v


def paged_attention_ref(q, k_pages, v_pages, page_table, lengths, *,
                        scale=None):
    B, H, hd = q.shape
    s, v = _dense(q, k_pages, v_pages, page_table, lengths, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / p.sum(-1, keepdim=True)
    y = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype).float(), v.float())
    return y.reshape(B, H, hd).to(q.dtype)


def paged_attention_split_ref(q, k_pages, v_pages, page_table, lengths, *,
                              n_split, row_tiles=1, scale=None):
    B, H, hd = q.shape
    KH = k_pages.shape[2]
    G = H // KH
    Gt = -(-G // row_tiles)
    if Gt < G:
        qg = q.reshape(B, KH, G, hd)
        tiles = [_split_rows(qg[:, :, g0:g0 + Gt].reshape(B, -1, hd),
                             k_pages, v_pages, page_table, lengths, n_split,
                             scale).reshape(B, KH, -1, hd)
                 for g0 in range(0, G, Gt)]
        return torch.cat(tiles, dim=2).reshape(B, H, hd)
    return _split_rows(q, k_pages, v_pages, page_table, lengths, n_split,
                       scale)


def _split_rows(q, k_pages, v_pages, page_table, lengths, n_split, scale):
    """One row tile: the page ranges' partials merged in split order."""
    B, H, hd = q.shape
    page_sz = k_pages.shape[1]
    nblk = page_table.shape[1]
    s, v = _dense(q, k_pages, v_pages, page_table, lengths, scale)
    vf = v.float()
    pps = -(-nblk // n_split)
    parts = []
    for i in range(n_split):
        lo = min(i * pps, nblk) * page_sz
        hi = min((i + 1) * pps, nblk) * page_sz
        s_i = s[..., lo:hi]
        if hi > lo:
            m_i = s_i.amax(-1)
        else:
            m_i = torch.full(s.shape[:-1], NEG_INF, device=s.device)
        p_i = torch.exp(s_i - m_i[..., None])
        acc_i = torch.einsum("bkgs,bskd->bkgd", p_i, vf[:, lo:hi])
        parts.append((m_i, p_i.sum(-1), acc_i))
    M = parts[0][0]
    for m_i, _, _ in parts[1:]:
        M = torch.maximum(M, m_i)
    l = torch.zeros_like(M)
    acc = torch.zeros_like(parts[0][2])
    for m_i, l_i, acc_i in parts:               # split order
        w = torch.exp(m_i - M)
        l = l + l_i * w
        acc = acc + acc_i * w[..., None]
    y = acc / torch.clamp_min(l, 1e-30)[..., None]
    return y.reshape(B, H, hd).to(q.dtype)
