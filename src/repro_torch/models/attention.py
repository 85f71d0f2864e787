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

On a mesh (``mesh=``, ``rules=``) the flash op runs on each rank's block
of JAX's heads-sharded layout (``repro/models/attention.py:162-188``):
batch on the batch axes, query heads on ``model``. K/V with as many heads
as q are split the same way. GQA K/V (fewer heads, ``kv_heads`` being
replicated) reach every rank whole, and each rank takes the KV heads its
query heads use, a slice where the groups line up with the shards: the
kernel keeps its G and no repeated copy is made (JAX repeats K/V to H
heads instead; the values are the same). Their gradient is then each
rank's share of a sum over the ranks (``Partial``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.kernels.flash_attention import ops as _flash_ops
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    NEG_INF, reference_attention)
from repro_torch.models import partitioning as part
from repro_torch.models.layers import apply_rope, rms_norm


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_chunk: int = 512, k_chunk: int = 0,
                    scale: Optional[float] = None,
                    schedule: str = "triangular", mesh=None, rules=None):
    """q: (B, S, H, hd); k: (B, Sk, KH, hd), v: (B, Sk, KH, hd_v) with
    H % KH == 0 (GQA); DTensors on ``mesh``.

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
    opts = dict(causal=causal, window=window, q_chunk=q_chunk,
                k_chunk=k_chunk, scale=scale, schedule=schedule)
    if mesh is not None:
        return _flash_blocks(q, k, v, mesh, rules, opts)
    if q.device.type == "cpu":
        qc = min(q_chunk, S)
        kc = min(k_chunk or qc, Sk)
        assert S % qc == 0 and Sk % kc == 0, (S, qc, Sk, kc)
    return _flash_ops.flash_attention(q, k, v, causal=causal, window=window,
                                      scale=float(scale), q_chunk=q_chunk,
                                      k_chunk=k_chunk, schedule=schedule)


def _flash_blocks(q, k, v, mesh, rules, opts):
    """The flash op on each rank's block (see the module docstring)."""
    H, KH = q.shape[2], k.shape[2]
    qpl = part.placements_for(
        part.spec_for(("batch", None, "heads", None), mesh, rules), mesh)
    hdims = [i for i, p in enumerate(qpl) if p == Shard(2)]
    if KH == H:
        kpl = qpl
        r = 0
    else:
        kpl = part.placements_for(
            part.spec_for(("batch", None, None, None), mesh, rules), mesh)
        # this rank's index along the mesh dims that split the heads
        coord, r = mesh.get_coordinate(), 0
        for i in hdims:
            r = r * mesh.size(i) + coord[i]
    G = H // KH

    def local(ql, kl, vl):
        Hl = ql.shape[2]
        if KH != H:
            h0 = r * Hl
            if Hl % G == 0 or G % Hl == 0:     # whole groups: a slice
                lo, n = h0 // G, max(Hl // G, 1)
                kl, vl = kl[:, :, lo:lo + n], vl[:, :, lo:lo + n]
            else:                              # one KV head a query head
                idx = torch.arange(h0, h0 + Hl, device=kl.device) // G
                kl, vl = kl[:, :, idx], vl[:, :, idx]
        return flash_attention(ql, kl, vl, **opts)

    return part.local_map(local, mesh, (qpl, kpl, kpl), qpl)(q, k, v)


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


def merge_shards(o, lse):
    """The whole softmax-weighted sum from the partials of R shards of one
    sequence, in fp32: o (R, B, H, hd) each shard's normalised output, lse
    (R, B, H) its log-sum-exp; returns Σ_r exp(lse_r − LSE)·o_r with LSE
    = logsumexp_r lse_r. A shard without a position (lse <= -1e30) weighs
    0. ``merge_over`` is the same sum across ranks."""
    lse = lse.float()
    w = torch.exp(lse - torch.logsumexp(lse, 0))
    return (w[..., None] * o.float()).sum(0)


def merge_over(o, lse, groups):
    """``merge_shards`` across the ranks of ``groups`` (process groups,
    one a mesh dim the sequence is split over), each rank holding its
    shard's o (B, H, hd) and lse (B, H): the largest lse by an all-reduce,
    then the weighted outputs and weights summed (one all-reduce of
    (B, H, hd + 1) fp32 a dim), Σ exp(lse_r − M)·o_r / Σ exp(lse_r − M),
    which is Σ exp(lse_r − LSE)·o_r. Returns (B, H, hd) in o's dtype."""
    from torch.distributed import _functional_collectives as funcol
    m = lse
    for g in groups:
        m = funcol.all_reduce(m, "max", g)
    w = torch.exp(lse - m)[..., None]
    part = torch.cat([o.float() * w, w], dim=-1)
    for g in groups:
        part = funcol.all_reduce(part, "sum", g)
    part = funcol.wait_tensor(part) if groups else part
    return (part[..., :-1] / part[..., -1:]).to(o.dtype)


# ---------------------------------------------------------------------------
# DeepSeek-V2 Multi-head Latent Attention
# ---------------------------------------------------------------------------

def mla_prefill(p, x, cos, sin, cfg, dtype, mesh=None, rules=None):
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
                        scale=1.0 / math.sqrt(nope + rope_d), mesh=mesh,
                        rules=rules)
    out = y.reshape(B, S, H * vd) @ p["wo"].to(dtype)
    return out, (ckv, kr[:, :, 0, :])


def mla_decode(p, x, ckv_cache, kr_cache, pos, cos, sin, cfg, dtype,
               mesh=None, rules=None):
    """Absorbed-matrix MLA decode: attention runs in the latent space
    (scores against the compressed cache), never forming per-head K/V.
    x: (B, 1, D); caches (B, Smax, lora) / (B, Smax, rope_d), written at
    ``pos`` in place (JAX returns updated copies). Products of cache-dtype
    operands accumulate in fp32, as JAX's ``preferred_element_type``.

    On a mesh (DTensors, the caches split on ``kv_seq``) the same plain
    torch on DTensors: the rank holding ``pos`` writes it at its local
    index (``write_at``), and DTensor gathers the scores over the
    sequence for the softmax, as GSPMD may; the values are JAX's."""
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
    if mesh is None:
        ckv_cache[:, pos] = ckv_new.to(ckv_cache.dtype)
        kr_cache[:, pos] = kr_new.to(kr_cache.dtype)
    else:
        write_at(ckv_cache, ckv_new, pos)
        write_at(kr_cache, kr_new, pos)

    wuk = p["wuk"].to(dtype).reshape(lora, H, nope)
    q_abs = torch.einsum("bhn,lhn->bhl", qn, wuk)          # absorb W_uk
    if mesh is not None:
        # the queries whole over their heads (small), as the paged path
        # gathers them: DTensor's einsum gives wrong scores from heads and
        # positions split on one mesh axis
        q_abs, qr = (part.constrain(t, mesh, "batch", None, None,
                                    rules=rules) for t in (q_abs, qr))
    s = (torch.einsum("bhl,bsl->bhs", q_abs.to(ckv_cache.dtype).float(),
                      ckv_cache.float())
         + torch.einsum("bhr,bsr->bhs", qr.to(kr_cache.dtype).float(),
                        kr_cache.float()))
    s = s * (1.0 / math.sqrt(nope + rope_d))
    valid = torch.arange(ckv_cache.shape[1], device=x.device) <= pos
    if mesh is not None:
        valid = part.replicate(valid, mesh)
    s = torch.where(valid[None, None], s, NEG_INF)
    p_att = torch.softmax(s, dim=-1)
    ol = torch.einsum("bhs,bsl->bhl", p_att.to(ckv_cache.dtype).float(),
                      ckv_cache.float())
    wuv = p["wuv"].to(dtype).reshape(lora, H, vd)
    y = torch.einsum("bhl,lhv->bhv", ol.to(dtype), wuv)
    out = torch.einsum("bhv,hvd->bd", y,
                       p["wo"].to(dtype).reshape(H, vd, D))
    return out[:, None], ckv_cache, kr_cache


# ---------------------------------------------------------------------------
# Decode caches split along their sequence (a mesh's ``kv_seq``)
# ---------------------------------------------------------------------------

def seq_shard(mesh, placements, seq_dim, length):
    """(this rank's shard index along a cache's sequence, the length of a
    shard, the process groups of the mesh dims that split it) for a cache
    whose ``placements`` split dim ``seq_dim`` of ``length`` positions:
    the shards are in row-major order of those mesh dims, as DTensor lays
    them out, and must be of one length."""
    dims = [i for i, p in enumerate(placements)
            if isinstance(p, Shard) and p.dim == seq_dim]
    coord, r, n = mesh.get_coordinate(), 0, 1
    for i in dims:
        r = r * mesh.size(i) + coord[i]
        n *= mesh.size(i)
    if length % n:
        raise ValueError(f"a cache of {length} positions does not split "
                         f"evenly over {n} shards")
    return r, length // n, [mesh.get_group(i) for i in dims]


def write_at(cache, new, idx, seq_dim=1):
    """Writes ``new`` (B, ...) at sequence position ``idx`` of ``cache``
    (a DTensor whose dim ``seq_dim`` is split on ``kv_seq``; dim 0 the
    batch) in place: only the rank whose shard holds ``idx`` writes, at
    its local index."""
    mesh, cpl = cache.device_mesh, cache.placements
    r, s_loc, _ = seq_shard(mesh, cpl, seq_dim, cache.shape[seq_dim])
    npl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
           for p in cpl]
    n = new.redistribute(mesh, npl).to_local()
    lo = r * s_loc
    if lo <= idx < lo + s_loc:
        cache.to_local().select(seq_dim, idx - lo).copy_(n)
