"""Plain PyTorch versions of the SSD: the kernel's four per-chunk pieces
(``ssd_chunk_ref``, the yardstick the CUDA kernel is held against), their
explicit gradient (``ssd_chunk_bwd_ref``, the yardstick of the backward
kernel) and the full chunked SSD of the model code (``ssd_ref``); the
split arithmetic of the bf16 tensor-core instances
(``ssd_chunk_split_ref``, ``ssd_chunk_bwd_split_ref``) and the backward
kernel's rule for head groups and tile pairs (``bwd_head_groups``,
``bwd_tile_pairs``)."""

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
    P = t.sc[..., None] * t.L
    dst_b = torch.einsum("ghpn,gjn->gjhp", dst, t.Bm)
    dxdt = torch.einsum("gijh,gihp->gjhp", P, dy) + t.w[..., None] * dst_b
    gg = torch.einsum("gihp,gjhp->gijh", dy, t.xdt)
    ds = (t.L * gg).sum(-1)                                # (g, i, j)
    dC = ds @ t.Bm
    dB = ds.transpose(1, 2) @ t.Cm + torch.einsum("gjh,gjhp,ghpn->gjn", t.w,
                                                  t.xdt, dst)
    u = t.w * (t.xdt * dst_b).sum(-1)                      # (g, j, nh)
    return _bwd_tail(t, x, dt, B_, C_, P, gg, u, dxdt, dB, dC, decs, detot)


def _bwd_tail(t, x, dt, B_, C_, P, gg, u, dxdt, dB, dC, decs, detot):
    """The decay gradient from r = P ⊙ g and u, and the outputs in their
    dtypes: the part of the backward that has no matrix product."""
    f, g, cl, nh = t.f, t.g, t.cl, t.nh
    decs = decs.to(f).reshape(g, cl, nh)
    detot = detot.to(f).reshape(g, nh)
    r = P * gg
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


# heads a CTA of the bf16 backward's head kernel (csrc/ssd_bwd.cu GROUP)
BWD_GROUP = 8
BWD_TILE = 64


def bwd_head_groups(nh: int, group: int = BWD_GROUP):
    """The bf16 backward kernel's head groups: runs of ``group``
    consecutive heads, the last one ragged. A CTA of its head kernel walks
    one group's heads in order, summing their ds partial; the groups'
    partials are then summed in group order."""
    return [range(h0, min(h0 + group, nh)) for h0 in range(0, nh, group)]


def bwd_tile_pairs(cl: int, tile: int = BWD_TILE):
    """The (row tile it, key tile jt) pairs of a chunk on or below the
    diagonal, as the kernel's scratch holds them: pair index it (it + 1) /
    2 + jt, with the rows and keys each tile has (the last tile ragged).
    Returns a list of (index, it, jt, rows, keys) in index order."""
    n = (cl + tile - 1) // tile
    out = [(it * (it + 1) // 2 + jt, it, jt, min(tile, cl - it * tile),
            min(tile, cl - jt * tile)) for it in range(n)
           for jt in range(it + 1)]
    return sorted(out)


# the bf16 backward kernel's pieces: (products with one exact bf16
# operand: the fp32 one split into this many bf16 values; Pᵀ·dy, both
# operands fp32: each split into this many, and the cross terms of
# ``_split_mm``). tests/test_torch_ssd_grad.py shows what one fewer of
# either costs.
BWD_PIECES = (2, 3)


def _split_mm(eq, a, b, pieces):
    """einsum(eq, a, b) as the bf16 kernel forms it when a and b are both
    fp32: each split into ``pieces`` bf16 values, and the products of
    piece m of a with piece n of b summed for m + n < pieces (the terms
    left out are below 2^(-9·pieces) of |a||b|)."""
    sa, sb = split_bf16(a, pieces), split_bf16(b, pieces)
    return sum(torch.einsum(eq, sa[m], sb[n]) for m in range(pieces)
               for n in range(pieces - m))


def _exact_mm(eq, a, b, pieces):
    """einsum(eq, a, b) with ``a`` bf16-valued (exact in every product)
    and ``b`` fp32 split into ``pieces`` bf16 values, one pass a piece."""
    return sum(torch.einsum(eq, a, p) for p in split_bf16(b, pieces))


def ssd_chunk_bwd_split_ref(x, dt, A_log, B_, C_, dy, dst, decs, detot, *,
                            chunk: int, pieces=BWD_PIECES):
    """``ssd_chunk_bwd_ref`` computed as the bf16 tensor-core instance of
    ``csrc/ssd_bwd.cu`` decomposes its products. x, B and C are bf16, so
    exact; ``pieces`` = (e, p), or one number for both:

      * s = C·Bᵀ in one pass (both operands exact);
      * g_ij = dt_j · (dy_i · x_j): dy split into e pieces, x exact, dt_j
        applied to the fp32 sum;
      * dst B_j and x_j · dst (the states' part of dB, scaled by
        w_j dt_j afterwards): dst split into e pieces, B and x exact;
      * dC = ds B and the dsᵀ C part of dB: ds split into e pieces, B and
        C exact;
      * dxdt_j += Σ_i P_ij dy_i: P and dy each split into p pieces, the
        cross terms of ``_split_mm``;
      * ds summed over the heads of each group (``bwd_head_groups``),
        then over the groups in order.

    As ``ssd_chunk_split_ref`` it emulates the split, not the tensor
    cores: sums run in the CPU's order. ``pieces=1`` is a single unsplit
    bf16 pass for every product."""
    e, p = (pieces, pieces) if isinstance(pieces, int) else pieces
    t = _chunk_terms(x, dt.float(), A_log, B_, C_, chunk)
    g, cl, nh, hp, ns = t.g, t.cl, t.nh, t.hp, t.ns
    dy = dy.float().reshape(g, cl, nh, hp)
    dst = dst.float().reshape(g, nh, hp, ns)
    P = t.sc[..., None] * t.L
    dst_b = _exact_mm("gjn,ghpn->gjhp", t.Bm, dst, e)
    dxdt = (_split_mm("gijh,gihp->gjhp", P, dy, p)
            + t.w[..., None] * dst_b)
    gg = _exact_mm("gjhp,gihp->gijh", t.xf, dy, e) * t.dtf[:, None, :, :]
    lg = t.L * gg                          # ds: Σ over groups of Σ over heads
    ds = sum(lg[..., heads].sum(-1) for heads in bwd_head_groups(nh))
    dC = _exact_mm("gjn,gij->gin", t.Bm, ds, e)
    xdst = _exact_mm("gjhp,ghpn->gjhn", t.xf, dst, e)
    dB = (_exact_mm("gin,gij->gjn", t.Cm, ds, e)
          + ((t.w * t.dtf)[..., None] * xdst).sum(2))
    u = t.w * t.dtf * (t.xf * dst_b).sum(-1)               # (g, j, nh)
    return _bwd_tail(t, x, dt, B_, C_, P, gg, u, dxdt, dB, dC, decs, detot)


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
