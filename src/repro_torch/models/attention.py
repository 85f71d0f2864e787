"""Attention for the port: prefill (flash) and decode paths.

PyTorch counterpart of ``repro.models.attention`` (same names, layouts
and casts). ``flash_attention`` runs the hand-written CUDA flash kernel on
CUDA tensors; on CPU tensors it runs the plain chunked online softmax with
the same two block schedules as the JAX package:

* ``rect``       — every (q-chunk, k-chunk) pair, causality by mask;
* ``triangular`` — only the pairs that intersect the causal (and SWA)
                   mask (``_block_pairs``), so no masked block is computed.

Both give the same output. The MLA functions and the flash backward come
with later slices of the port (see ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.flash_attention import ops as _flash_ops

NEG_INF = -1e30


def _block_pairs(nq: int, nk: int, q_chunk: int, k_chunk: int,
                 causal: bool, window: int) -> Tuple[np.ndarray, np.ndarray]:
    """Static (i, j) block pair list intersecting the causal/SWA mask."""
    pairs = []
    for i in range(nq):
        q_lo, q_hi = i * q_chunk, (i + 1) * q_chunk - 1
        for j in range(nk):
            k_lo, k_hi = j * k_chunk, (j + 1) * k_chunk - 1
            if causal and k_lo > q_hi:
                continue
            if window and k_hi < q_lo - window + 1:
                continue
            pairs.append((i, j))
    arr = np.asarray(pairs, np.int32)
    return arr[:, 0], arr[:, 1]


def _allowed(gq, gk, causal: bool, window: int):
    allow = torch.ones((gq.shape[0], gk.shape[0]), dtype=torch.bool,
                       device=gq.device)
    if causal:
        allow &= gk[None, :] <= gq[:, None]
    if window:
        allow &= gk[None, :] > gq[:, None] - window
    return allow


def _block_scores(q_blk, k_blk, scale, gq, gk, causal, window):
    """One (q_chunk × k_chunk) score block with mask applied. fp32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q_blk.float(), k_blk.float()) * scale
    return torch.where(_allowed(gq, gk, causal, window)[None, None], s,
                       NEG_INF)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_chunk: int = 512, k_chunk: int = 0,
                    scale: Optional[float] = None,
                    schedule: str = "triangular"):
    """q: (B, S, H, hd); k, v: (B, Sk, KH, hd) with H % KH == 0 (GQA).

    Returns (B, S, H, hd) in q's dtype. On a CUDA tensor this launches the
    flash kernel, which maps query head h to KV head h // (H/KH) itself
    and picks its own tiles (``q_chunk``/``k_chunk``/``schedule`` shape
    only the CPU path)."""
    B, S, H, hd = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    if q.device.type != "cpu":
        return _flash_ops.flash_attention(q, k, v, causal=causal,
                                          window=window, scale=scale)
    if H != KH:
        k = k.repeat_interleave(H // KH, dim=2)
        v = v.repeat_interleave(H // KH, dim=2)
    q_chunk = min(q_chunk, S)
    k_chunk = min(k_chunk or q_chunk, Sk)
    assert S % q_chunk == 0 and Sk % k_chunk == 0, (S, q_chunk, Sk, k_chunk)
    return _fwd_blocks(q, k, v, causal, window, q_chunk, k_chunk,
                       float(scale), schedule)


def _fwd_blocks(q, k, v, causal, window, q_chunk, k_chunk, scale, schedule):
    """Chunked online softmax over the schedule's block pairs (CPU path)."""
    B, S, H, hd = q.shape
    Sk = k.shape[1]
    hdv = v.shape[-1]
    nq, nk = S // q_chunk, Sk // k_chunk
    if schedule == "rect":
        pairs = [(i, j) for i in range(nq) for j in range(nk)]
    else:
        pairs = list(zip(*(a.tolist() for a in _block_pairs(
            nq, nk, q_chunk, k_chunk, causal, window))))
    dev = q.device
    m = [torch.full((B, H, q_chunk), NEG_INF, device=dev) for _ in range(nq)]
    l = [torch.zeros((B, H, q_chunk), device=dev) for _ in range(nq)]
    acc = [torch.zeros((B, H, q_chunk, hdv), device=dev) for _ in range(nq)]
    ar_q = torch.arange(q_chunk, device=dev)
    ar_k = torch.arange(k_chunk, device=dev)
    for i, j in pairs:
        q_blk = q[:, i * q_chunk:(i + 1) * q_chunk]
        k_blk = k[:, j * k_chunk:(j + 1) * k_chunk]
        v_blk = v[:, j * k_chunk:(j + 1) * k_chunk]
        s = _block_scores(q_blk, k_blk, scale, i * q_chunk + ar_q,
                          j * k_chunk + ar_k, causal, window)
        m_new = torch.maximum(m[i], s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m[i] - m_new)
        l[i] = l[i] * corr + p.sum(-1)
        acc[i] = acc[i] * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, v_blk.float())
        m[i] = m_new
    y = torch.cat([a / torch.clamp_min(li, 1e-30)[..., None]
                   for a, li in zip(acc, l)], dim=2)      # (B,H,S,hdv)
    return y.permute(0, 2, 1, 3).to(q.dtype)


def reference_attention(q, k, v, *, causal=True, window=0, scale=None):
    """O(S²)-memory oracle: the plain version of the flash kernel."""
    B, S, H, hd = q.shape
    KH = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    if H != KH:
        k = k.repeat_interleave(H // KH, dim=2)
        v = v.repeat_interleave(H // KH, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    dev = q.device
    allow = _allowed(torch.arange(S, device=dev),
                     torch.arange(k.shape[1], device=dev), causal, window)
    s = torch.where(allow[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    y = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return y.to(q.dtype)


# ---------------------------------------------------------------------------
# Decode (one query token against a KV cache)
# ---------------------------------------------------------------------------

def decode_attention(q, k_cache, v_cache, pos, *, window: int = 0,
                     scale: Optional[float] = None):
    """q: (B, H, hd); caches: (B, Smax, KH, hd). ``pos``: current position
    (the new token's K/V must already be written at index ``pos`` — or at
    ``pos % window`` for a ring-buffer SWA cache).

    Keeps the JAX casts: q is cast to the cache dtype before the scores and
    p to the V dtype before the weighted sum; products accumulate in fp32.
    """
    B, H, hd = q.shape
    Smax, KH = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, KH, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg.to(k_cache.dtype).float(),
                     k_cache.float()) * scale
    valid = torch.arange(Smax, device=q.device) <= pos
    if window:
        # ring buffer: all slots valid once pos >= window-1
        valid = valid | (pos >= Smax)
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / p.sum(-1, keepdim=True)
    y = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return y.reshape(B, H, v_cache.shape[-1]).to(q.dtype)
