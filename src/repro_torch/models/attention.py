"""Attention for the port: prefill and training (flash) and decode paths.

PyTorch counterpart of ``repro.models.attention`` (same names, layouts
and casts). ``flash_attention`` goes through ``FlashAttention``
(``kernels/flash_attention/ops.py``), the port's counterpart of the JAX
``custom_vjp``: on CUDA tensors the hand-written flash forward and
backward kernels, on CPU tensors the plain chunked online softmax and the
block-recompute backward (``kernels/flash_attention/ref.py``) with the
same two block schedules as the JAX package:

* ``rect``       — every (q-chunk, k-chunk) pair, causality by mask;
* ``triangular`` — only the pairs that intersect the causal (and SWA)
                   mask (``ref.block_pairs``), so no masked block is computed.

Both give the same output. The MLA functions come with a later slice of
the port (see ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.flash_attention import ops as _flash_ops
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    NEG_INF, reference_attention)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_chunk: int = 512, k_chunk: int = 0,
                    scale: Optional[float] = None,
                    schedule: str = "triangular"):
    """q: (B, S, H, hd); k, v: (B, Sk, KH, hd) with H % KH == 0 (GQA).

    Returns (B, S, H, hd) in q's dtype, differentiable in q, k and v. On
    a CUDA tensor this launches the flash kernels, which map query head h
    to KV head h // (H/KH) themselves and pick their own tiles
    (``q_chunk``/``k_chunk``/``schedule`` shape only the CPU path). No
    repeated copy of K/V is made or saved: the backward sums the G query
    heads of a KV head itself."""
    B, S, H, hd = q.shape
    Sk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    if q.device.type == "cpu":
        qc = min(q_chunk, S)
        kc = min(k_chunk or qc, Sk)
        assert S % qc == 0 and Sk % kc == 0, (S, qc, Sk, kc)
    return _flash_ops.flash_attention(q, k, v, causal=causal, window=window,
                                      scale=float(scale), q_chunk=q_chunk,
                                      k_chunk=k_chunk, schedule=schedule)


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
