"""Plain PyTorch versions of the SSD: the kernel's four per-chunk pieces
(``ssd_chunk_ref``, the yardstick the CUDA kernel is held against), their
explicit gradient (``ssd_chunk_bwd_ref``, the yardstick of the backward
kernel) and the full chunked SSD of the model code (``ssd_ref``)."""

from __future__ import annotations

from types import SimpleNamespace

import torch

from repro_torch.models import mamba as _mamba


def _chunk_terms(x, dt, A_log, B_, C_, chunk):
    """The forward's per-chunk intermediates, shared by ``ssd_chunk_ref``
    and ``ssd_chunk_bwd_ref``, for all (batch, chunk) pairs g = B * nc and
    heads at once: fp32 arithmetic (fp64 when ``dt`` is fp64, the tests'
    yardstick for the gradient), with cs accumulated in fp64 as the CUDA
    kernels do (``csrc/ssd_chunk.cu``'s header says why) and the
    differences cs_i - cs_j rounded to the compute dtype before the exp,
    the upper triangle masked before it."""
    f = torch.float64 if dt.dtype == torch.float64 else torch.float32
    B, S, nh, hp = x.shape
    ns = B_.shape[-1]
    cl = min(chunk, S)
    if S % cl:
        raise ValueError(f"S={S} is not a multiple of the chunk {cl}")
    nc = S // cl
    g = B * nc
    dtf = dt.to(f).reshape(g, cl, nh)
    A = -torch.exp(A_log.to(f))
    Bm = B_.to(f).reshape(g, cl, ns)
    Cm = C_.to(f).reshape(g, cl, ns)
    xf = x.to(f).reshape(g, cl, nh, hp)
    cs = torch.cumsum((dtf * A).double(), dim=1)           # (g, cl, nh)
    xdt = xf * dtf[..., None]
    sc = Cm @ Bm.transpose(1, 2)                           # (g, i, j)
    tri = torch.ones((cl, cl), dtype=torch.bool, device=x.device).tril()
    seg = (cs[:, :, None, :] - cs[:, None, :, :]).to(f)    # (g, i, j, nh)
    L = torch.exp(torch.where(tri[None, :, :, None], seg, -1e9))
    total = cs[:, -1:, :]                                  # (g, 1, nh)
    w = torch.exp((total - cs).to(f))                      # (g, j, nh)
    return SimpleNamespace(f=f, B=B, nc=nc, g=g, cl=cl, nh=nh, hp=hp, ns=ns,
                           dtf=dtf, A=A, Bm=Bm, Cm=Cm, xf=xf, cs=cs, xdt=xdt,
                           sc=sc, L=L, total=total, w=w)


def ssd_chunk_ref(x, dt, A_log, B_, C_, *, chunk: int):
    """The pieces of ``kernel.ssd_chunk_call`` (same shapes, fp32; fp64
    for fp64 inputs), computed as the Pallas body does, for all (batch,
    chunk) pairs and heads at once (``_chunk_terms``)."""
    t = _chunk_terms(x, dt, A_log, B_, C_, chunk)
    y = torch.einsum("gijh,gjhp->gihp", t.sc[..., None] * t.L, t.xdt)
    st = torch.einsum("gjhp,gjn->ghpn", t.xdt * t.w[..., None], t.Bm)
    return (y.reshape(t.B, t.nc, t.cl, t.nh, t.hp),
            st.reshape(t.B, t.nc, t.nh, t.hp, t.ns),
            torch.exp(t.cs.to(t.f)).reshape(t.B, t.nc, t.cl, t.nh),
            torch.exp(t.total.to(t.f)).reshape(t.B, t.nc, t.nh))


def ssd_chunk_bwd_ref(x, dt, A_log, B_, C_, dy, dst, decs, detot, *,
                      chunk: int):
    """The gradient of ``ssd_chunk_ref``'s four pieces, written out (the
    formulas of ``csrc/ssd_bwd.cu``), for all (batch, chunk) pairs and
    heads at once. ``dy`` (B, nc, cl, nh, hp), ``dst`` (B, nc, nh, hp,
    ns), ``decs`` (B, nc, cl, nh) and ``detot`` (B, nc, nh) are the
    cotangents of y_diag, states, exp_cs and exp_tot. Per head, with
    P = (C Bᵀ) ⊙ L, g_ij = dy_i · xdt_j and w_j = exp(total - cs_j):

      dxdt_j = Σ_i P_ij dy_i + w_j dst B_j
      ds_ij  = Σ_h L_ij g_ij;  dC = ds B;  dB = dsᵀ C + Σ_h w xdt dstᵀ
      dcs    = rowsum(P ⊙ g) - colsum(P ⊙ g) - u + decs exp(cs),
               u_j = w_j xdt_j · (dst B_j), and at the last token
               + Σ_j u_j + detot exp(total)
      d(dt·A) = the reverse cumsum of dcs (fp64, as cs is summed)

    Returns (dx, ddt, dA_log, dB, dC): dx, dB and dC in their inputs'
    dtypes, ddt and dA_log fp32 (fp64 for fp64 inputs)."""
    t = _chunk_terms(x, dt, A_log, B_, C_, chunk)
    f, g, cl, nh, hp, ns = t.f, t.g, t.cl, t.nh, t.hp, t.ns
    dy = dy.to(f).reshape(g, cl, nh, hp)
    dst = dst.to(f).reshape(g, nh, hp, ns)
    decs = decs.to(f).reshape(g, cl, nh)
    detot = detot.to(f).reshape(g, nh)
    P = t.sc[..., None] * t.L
    dst_b = torch.einsum("ghpn,gjn->gjhp", dst, t.Bm)
    dxdt = torch.einsum("gijh,gihp->gjhp", P, dy) + t.w[..., None] * dst_b
    gg = torch.einsum("gihp,gjhp->gijh", dy, t.xdt)
    ds = (t.L * gg).sum(-1)                                # (g, i, j)
    dC = ds @ t.Bm
    dB = ds.transpose(1, 2) @ t.Cm + torch.einsum("gjh,gjhp,ghpn->gjn", t.w,
                                                  t.xdt, dst)
    r = P * gg
    u = t.w * (t.xdt * dst_b).sum(-1)                      # (g, j, nh)
    dcs = (r.sum(2).double() - r.sum(1).double() - u.double()
           + (decs * torch.exp(t.cs.to(f))).double())
    dcs[:, -1] += u.sum(1).double() + (detot * torch.exp(
        t.total[:, 0].to(f))).double()
    dda = torch.flip(torch.cumsum(torch.flip(dcs, (1,)), 1), (1,)).to(f)
    ddt = (dxdt * t.xf).sum(-1) + dda * t.A
    dx = dxdt * t.dtf[..., None]
    dA_log = (dda * t.dtf).sum((0, 1)) * t.A
    return (dx.reshape(x.shape).to(x.dtype), ddt.reshape(dt.shape), dA_log,
            dB.reshape(B_.shape).to(B_.dtype),
            dC.reshape(C_.shape).to(C_.dtype))


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
    t = _chunk_terms(x, dt.float(), A_log, B_, C_, chunk)
    a = (t.sc[..., None] * t.L) * t.dtf[:, None, :, :]     # (g, i, j, nh)
    y = sum(torch.einsum("gijh,gjhp->gihp", p, t.xf)
            for p in split_bf16(a, pieces))
    st = sum(torch.einsum("gjhp,gjn->ghpn", p, t.Bm)
             for p in split_bf16(t.xdt * t.w[..., None], pieces))
    return (y.reshape(t.B, t.nc, t.cl, t.nh, t.hp),
            st.reshape(t.B, t.nc, t.nh, t.hp, t.ns),
            torch.exp(t.cs.float()).reshape(t.B, t.nc, t.cl, t.nh),
            torch.exp(t.total.float()).reshape(t.B, t.nc, t.nh))


def ssd_ref(x, dt, A_log, B_, C_, D_, chunk, state=None):
    """(y, final_state) of the plain chunked SSD, ``mamba.ssd_chunked``."""
    return _mamba.ssd_chunked(x, dt, A_log, B_, C_, D_, chunk, state=state,
                              return_state=True)
