"""Plain PyTorch versions of the flash attention kernels: the forward with
its log-sum-exp, the block-recompute backward, and the O(S²) oracle.

``flash_attention_fwd_ref`` is the chunked online softmax of
``repro/models/attention.py:_fwd_blocks`` and ``flash_attention_bwd_ref``
the block-recompute backward of its custom VJP (``attention.py:211-286``):
the same two block schedules,

* ``rect``       — every (q-chunk, k-chunk) pair, causality by mask;
* ``triangular`` — only the pairs that intersect the causal (and SWA)
                   mask (``block_pairs``), so no masked block is computed,

fp32 arithmetic from inputs of any dtype, results cast to the inputs'
dtype. A last chunk may be shorter than the others (the CUDA kernels take
any S). GQA: query head h reads KV head h // (H / KH); the backward sums
the G query heads of a KV head into its dk/dv.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

NEG_INF = -1e30


def block_pairs(nq: int, nk: int, q_chunk: int, k_chunk: int,
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


def _schedule_pairs(schedule, nq, nk, q_chunk, k_chunk, causal,
                    window) -> List[Tuple[int, int]]:
    if schedule == "rect":
        return [(i, j) for i in range(nq) for j in range(nk)]
    return list(zip(*(a.tolist() for a in block_pairs(
        nq, nk, q_chunk, k_chunk, causal, window))))


def allowed(gq, gk, causal: bool, window: int):
    allow = torch.ones((gq.shape[0], gk.shape[0]), dtype=torch.bool,
                       device=gq.device)
    if causal:
        allow &= gk[None, :] <= gq[:, None]
    if window:
        allow &= gk[None, :] > gq[:, None] - window
    return allow


def block_scores(q_blk, k_blk, scale, gq, gk, causal, window):
    """One (q_chunk × k_chunk) score block with mask applied. fp32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q_blk.float(), k_blk.float()) * scale
    return torch.where(allowed(gq, gk, causal, window)[None, None], s,
                       NEG_INF)


def _chunks(S, Sk, q_chunk, k_chunk):
    q_chunk = min(q_chunk, S)
    k_chunk = min(k_chunk or q_chunk, Sk)
    return q_chunk, k_chunk, -(-S // q_chunk), -(-Sk // k_chunk)


def _repeat_kv(t, G):
    return t.repeat_interleave(G, dim=2) if G > 1 else t


def flash_attention_fwd_ref(q, k, v, *, causal: bool = True, window: int = 0,
                            scale: float | None = None, q_chunk: int = 512,
                            k_chunk: int = 0, schedule: str = "triangular"):
    """q: (B, S, H, hd); k/v: (B, Sk, KH, hd). Returns (o (B, S, H, hd) in
    q's dtype, lse (B, H, S) fp32): lse is the natural log of the softmax
    denominator of the *scaled* scores, m + log(max(l, 1e-30)), as
    ``repro/models/attention.py:147-150`` defines it."""
    B, S, H, hd = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    k, v = _repeat_kv(k, H // KH), _repeat_kv(v, H // KH)
    hdv = v.shape[-1]
    qc, kc, nq, nk = _chunks(S, Sk, q_chunk, k_chunk)
    dev = q.device
    rows = [min(qc, S - i * qc) for i in range(nq)]
    m = [torch.full((B, H, r), NEG_INF, device=dev) for r in rows]
    l = [torch.zeros((B, H, r), device=dev) for r in rows]
    acc = [torch.zeros((B, H, r, hdv), device=dev) for r in rows]
    for i, j in _schedule_pairs(schedule, nq, nk, qc, kc, causal, window):
        q0, k0 = i * qc, j * kc
        k_blk, v_blk = k[:, k0:k0 + kc], v[:, k0:k0 + kc]
        s = block_scores(q[:, q0:q0 + qc], k_blk, scale,
                         torch.arange(q0, q0 + rows[i], device=dev),
                         torch.arange(k0, k0 + k_blk.shape[1], device=dev),
                         causal, window)
        m_new = torch.maximum(m[i], s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m[i] - m_new)
        l[i] = l[i] * corr + p.sum(-1)
        acc[i] = acc[i] * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, v_blk.float())
        m[i] = m_new
    l_safe = [torch.clamp_min(li, 1e-30) for li in l]
    y = torch.cat([a / ls[..., None] for a, ls in zip(acc, l_safe)], dim=2)
    lse = torch.cat([mi + torch.log(ls) for mi, ls in zip(m, l_safe)], dim=2)
    return y.permute(0, 2, 1, 3).to(q.dtype), lse


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            window: int = 0, scale: float | None = None,
                            q_chunk: int = 512, k_chunk: int = 0,
                            schedule: str = "triangular"):
    """The block-recompute backward: from (q, k, v, o, lse) and the output
    gradient do (B, S, H, hd), returns (dq, dk, dv) in the dtypes of
    q, k, v. Per block pair: p = exp(s − lse), dv += pᵀ·do,
    dp = do·vᵀ, ds = p·(dp − D)·scale, dq += ds·k, dk += dsᵀ·q, with
    D = rowsum(do·o), all in fp32."""
    B, S, H, hd = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    kr, vr = _repeat_kv(k, G), _repeat_kv(v, G)
    hdv = v.shape[-1]
    qc, kc, nq, nk = _chunks(S, Sk, q_chunk, k_chunk)
    dev = q.device
    dof = do.float()
    D = (dof * o.float()).sum(-1).permute(0, 2, 1)          # (B, H, S)
    dq = torch.zeros((B, S, H, hd), device=dev)
    dk = torch.zeros((B, Sk, H, hd), device=dev)
    dv = torch.zeros((B, Sk, H, hdv), device=dev)
    for i, j in _schedule_pairs(schedule, nq, nk, qc, kc, causal, window):
        q0, k0 = i * qc, j * kc
        q_blk, do_blk = q[:, q0:q0 + qc], dof[:, q0:q0 + qc]
        k_blk, v_blk = kr[:, k0:k0 + kc], vr[:, k0:k0 + kc]
        gq = torch.arange(q0, q0 + q_blk.shape[1], device=dev)
        gk = torch.arange(k0, k0 + k_blk.shape[1], device=dev)
        s = block_scores(q_blk, k_blk, scale, gq, gk, causal, window)
        p = torch.exp(s - lse[:, :, q0:q0 + qc, None])       # (B,H,qc,kc)
        dv[:, k0:k0 + kc] += torch.einsum("bhqk,bqhd->bkhd", p, do_blk)
        dp = torch.einsum("bqhd,bkhd->bhqk", do_blk, v_blk.float())
        ds = p * (dp - D[:, :, q0:q0 + qc, None]) * scale
        dq[:, q0:q0 + qc] += torch.einsum("bhqk,bkhd->bqhd", ds,
                                          k_blk.float())
        dk[:, k0:k0 + kc] += torch.einsum("bhqk,bqhd->bkhd", ds,
                                          q_blk.float())
    if G > 1:
        dk = dk.view(B, Sk, KH, G, hd).sum(3)
        dv = dv.view(B, Sk, KH, G, hdv).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def reference_attention(q, k, v, *, causal=True, window=0, scale=None):
    """O(S²)-memory oracle: the plain version of the flash forward kernel
    (differentiable by autograd)."""
    B, S, H, hd = q.shape
    KH = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    k, v = _repeat_kv(k, H // KH), _repeat_kv(v, H // KH)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    dev = q.device
    allow = allowed(torch.arange(S, device=dev),
                    torch.arange(k.shape[1], device=dev), causal, window)
    s = torch.where(allow[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    y = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return y.to(q.dtype)
