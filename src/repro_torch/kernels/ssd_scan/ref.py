"""Plain PyTorch versions of the SSD: the kernel's four per-chunk pieces
(``ssd_chunk_ref``, the yardstick the CUDA kernel is held against) and the
full chunked SSD of the model code (``ssd_ref``)."""

from __future__ import annotations

import torch

from repro_torch.models import mamba as _mamba


def ssd_chunk_ref(x, dt, A_log, B_, C_, *, chunk: int):
    """The pieces of ``kernel.ssd_chunk_call`` (same shapes, fp32), computed
    as the Pallas body does, for all (batch, chunk) pairs and heads at
    once, with cs accumulated in fp64 as the CUDA kernel does (its header
    says why); the differences cs_i - cs_j are rounded to fp32 before the
    exp."""
    B, S, nh, hp = x.shape
    ns = B_.shape[-1]
    cl = min(chunk, S)
    if S % cl:
        raise ValueError(f"S={S} is not a multiple of the chunk {cl}")
    nc = S // cl
    g = B * nc
    dtf = dt.float().reshape(g, cl, nh)
    A = -torch.exp(A_log.float())
    Bm = B_.float().reshape(g, cl, ns)
    Cm = C_.float().reshape(g, cl, ns)
    cs = torch.cumsum((dtf * A).double(), dim=1)           # (g, cl, nh)
    xdt = x.float().reshape(g, cl, nh, hp) * dtf[..., None]
    sc = Cm @ Bm.transpose(1, 2)                           # (g, cl, cl)
    tri = torch.ones((cl, cl), dtype=torch.bool, device=x.device).tril()
    seg = (cs[:, :, None, :] - cs[:, None, :, :]).float()  # (g, i, j, nh)
    L = torch.exp(torch.where(tri[None, :, :, None], seg, -1e9))
    y = torch.einsum("gijh,gjhp->gihp", sc[..., None] * L, xdt)
    total = cs[:, -1:, :]                                  # (g, 1, nh)
    xw = xdt * torch.exp((total - cs).float())[..., None]
    st = torch.einsum("gjhp,gjn->ghpn", xw, Bm)
    return (y.reshape(B, nc, cl, nh, hp), st.reshape(B, nc, nh, hp, ns),
            torch.exp(cs.float()).reshape(B, nc, cl, nh),
            torch.exp(total.float()).reshape(B, nc, nh))


def split_bf16(a, pieces: int = 3):
    """fp32 ``a`` as ``pieces`` bf16 values (each rounded to nearest even,
    as ``__float2bfloat16_rn``) whose sum is ``a`` to about 2^(-9·pieces)
    of |a|: hi = bf16(a), mid = bf16(a - hi), lo = bf16(a - hi - mid).
    Returned as fp32 tensors (bf16 values widen exactly)."""
    out, rest = [], a
    for _ in range(pieces):
        p = rest.to(torch.bfloat16).float()
        out.append(p)
        rest = rest - p
    return out


def ssd_chunk_split_ref(x, dt, A_log, B_, C_, *, chunk: int, pieces: int = 3):
    """The pieces of ``kernel.ssd_chunk_call`` computed as the bf16
    tensor-core instance of ``csrc/ssd_chunk.cu`` decomposes them:

      * s = C·Bᵀ from the bf16 values as they are (every product of two
        bf16 values is exact in fp32, so one bf16 pass with fp32 sums is
        the fp32 product up to the order of the sum);
      * a = (s ⊙ L) · dt_j in fp32, with L = exp(cs_i - cs_j) on the lower
        triangle (cs in fp64, the difference rounded to fp32) and 0 above
        it, split into ``pieces`` bf16 values (``split_bf16``); y = Σ over
        the pieces of piece · x, with x bf16 and so exact;
      * the states: w = (x · dt_j) · exp(total - cs_j) in fp32, split the
        same way; st = Σ over the pieces of pieceᵀ · B.

    Each product of a piece and a bf16 value is exact in fp32, so what this
    emulates is the split itself, not the tensor cores: it sums in the
    CPU's order, not the order of the kernel's ``mma`` accumulators, which
    differ from it by fp32 rounding of the sums. ``pieces=1`` is a single
    unsplit bf16 pass. exp_cs and exp_tot are as in ``ssd_chunk_ref``."""
    B, S, nh, hp = x.shape
    ns = B_.shape[-1]
    cl = min(chunk, S)
    if S % cl:
        raise ValueError(f"S={S} is not a multiple of the chunk {cl}")
    nc = S // cl
    g = B * nc
    dtf = dt.float().reshape(g, cl, nh)
    A = -torch.exp(A_log.float())
    Bm = B_.float().reshape(g, cl, ns)
    Cm = C_.float().reshape(g, cl, ns)
    xf = x.float().reshape(g, cl, nh, hp)
    cs = torch.cumsum((dtf * A).double(), dim=1)           # (g, cl, nh)
    sc = Cm @ Bm.transpose(1, 2)                           # (g, cl, cl)
    tri = torch.ones((cl, cl), dtype=torch.bool, device=x.device).tril()
    seg = (cs[:, :, None, :] - cs[:, None, :, :]).float()  # (g, i, j, nh)
    L = torch.exp(torch.where(tri[None, :, :, None], seg, -1e9))
    a = (sc[..., None] * L) * dtf[:, None, :, :]           # (g, i, j, nh)
    y = sum(torch.einsum("gijh,gjhp->gihp", p, xf)
            for p in split_bf16(a, pieces))
    total = cs[:, -1:, :]
    w = (xf * dtf[..., None]) * torch.exp((total - cs).float())[..., None]
    st = sum(torch.einsum("gjhp,gjn->ghpn", p, Bm)
             for p in split_bf16(w, pieces))
    return (y.reshape(B, nc, cl, nh, hp), st.reshape(B, nc, nh, hp, ns),
            torch.exp(cs.float()).reshape(B, nc, cl, nh),
            torch.exp(total.float()).reshape(B, nc, nh))


def ssd_ref(x, dt, A_log, B_, C_, D_, chunk, state=None):
    """(y, final_state) of the plain chunked SSD, ``mamba.ssd_chunked``."""
    return _mamba.ssd_chunked(x, dt, A_log, B_, C_, D_, chunk, state=state,
                              return_state=True)
