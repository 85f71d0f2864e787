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


def ssd_ref(x, dt, A_log, B_, C_, D_, chunk, state=None):
    """(y, final_state) of the plain chunked SSD, ``mamba.ssd_chunked``."""
    return _mamba.ssd_chunked(x, dt, A_log, B_, C_, D_, chunk, state=state,
                              return_state=True)
