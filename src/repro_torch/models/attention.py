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

Both give the same output.

DeepSeek-V2's Multi-head Latent Attention: ``mla_prefill`` decompresses
K/V from the latent and runs the flash op at a q/k head dim of
nope + rope (192 at full width) and a v head dim of v_head_dim (128);
``mla_decode`` is the absorbed form in plain torch, attention in the
latent space against the compressed cache (the JAX package has no kernel
for it either).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.flash_attention import ops as _flash_ops
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    NEG_INF, reference_attention)
from repro_torch.models.layers import apply_rope, rms_norm


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_chunk: int = 512, k_chunk: int = 0,
                    scale: Optional[float] = None,
                    schedule: str = "triangular"):
    """q: (B, S, H, hd); k: (B, Sk, KH, hd), v: (B, Sk, KH, hd_v) with
    H % KH == 0 (GQA).

    Returns (B, S, H, hd_v) in q's dtype, differentiable in q, k and v. On
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


# ---------------------------------------------------------------------------
# DeepSeek-V2 Multi-head Latent Attention
# ---------------------------------------------------------------------------

def mla_prefill(p, x, cos, sin, cfg, dtype):
    """Full (decompressed) MLA for train/prefill. Returns (out, (ckv,
    k_rope)) so serving can keep only the compressed cache."""
    m = cfg.mla
    B, S, D = x.shape
    H = cfg.n_heads
    nope, rope_d, vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    lora = m.kv_lora_rank
    q = (x @ p["wq"].to(dtype)).reshape(B, S, H, nope + rope_d)
    qn, qr = q[..., :nope], q[..., nope:]
    qr = apply_rope(qr, cos, sin)

    dkv = x @ p["wdkv"].to(dtype)
    ckv = rms_norm(dkv[..., :lora], p["ckv_norm"], cfg.norm_eps)
    kr = apply_rope(dkv[..., None, lora:], cos, sin)        # (B,S,1,r)

    kn = (ckv @ p["wuk"].to(dtype)).reshape(B, S, H, nope)
    v = (ckv @ p["wuv"].to(dtype)).reshape(B, S, H, vd)
    k = torch.cat([kn, kr.expand(B, S, H, rope_d)], -1)
    qf = torch.cat([qn, qr], -1)
    y = flash_attention(qf, k, v, causal=True, q_chunk=cfg.attn_q_chunk,
                        scale=1.0 / math.sqrt(nope + rope_d))
    out = y.reshape(B, S, H * vd) @ p["wo"].to(dtype)
    return out, (ckv, kr[:, :, 0, :])


def mla_decode(p, x, ckv_cache, kr_cache, pos, cos, sin, cfg, dtype):
    """Absorbed-matrix MLA decode: attention runs in the latent space
    (scores against the compressed cache), never forming per-head K/V.
    x: (B, 1, D); caches (B, Smax, lora) / (B, Smax, rope_d), written at
    ``pos`` in place (JAX returns updated copies). Products of cache-dtype
    operands accumulate in fp32, as JAX's ``preferred_element_type``."""
    m = cfg.mla
    B, _, D = x.shape
    H = cfg.n_heads
    nope, rope_d, vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    lora = m.kv_lora_rank

    q = (x @ p["wq"].to(dtype)).reshape(B, H, nope + rope_d)
    qn, qr = q[..., :nope], q[..., nope:]
    qr = apply_rope(qr[:, None], cos, sin)[:, 0]          # (B,H,r)

    dkv = x[:, 0] @ p["wdkv"].to(dtype)
    ckv_new = rms_norm(dkv[..., :lora], p["ckv_norm"], cfg.norm_eps)
    kr_new = apply_rope(dkv[:, None, None, lora:], cos, sin)[:, 0, 0]
    ckv_cache[:, pos] = ckv_new.to(ckv_cache.dtype)
    kr_cache[:, pos] = kr_new.to(kr_cache.dtype)

    wuk = p["wuk"].to(dtype).reshape(lora, H, nope)
    q_abs = torch.einsum("bhn,lhn->bhl", qn, wuk)          # absorb W_uk
    s = (torch.einsum("bhl,bsl->bhs", q_abs.to(ckv_cache.dtype).float(),
                      ckv_cache.float())
         + torch.einsum("bhr,bsr->bhs", qr.to(kr_cache.dtype).float(),
                        kr_cache.float()))
    s = s * (1.0 / math.sqrt(nope + rope_d))
    valid = torch.arange(ckv_cache.shape[1], device=x.device) <= pos
    s = torch.where(valid[None, None], s, NEG_INF)
    p_att = torch.softmax(s, dim=-1)
    ol = torch.einsum("bhs,bsl->bhl", p_att.to(ckv_cache.dtype).float(),
                      ckv_cache.float())
    wuv = p["wuv"].to(dtype).reshape(lora, H, vd)
    y = torch.einsum("bhl,lhv->bhv", ol.to(dtype), wuv)
    out = torch.einsum("bhv,hvd->bd", y,
                       p["wo"].to(dtype).reshape(H, vd, D))
    return out[:, None], ckv_cache, kr_cache
