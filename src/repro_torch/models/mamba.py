"""Mamba2 (SSD — state-space duality) block (``mesh=None`` path of
``repro.models.mamba``).

``ssd_chunked`` is the plain chunked SSD of the JAX package: a loop over
chunks with the quadratic intra-chunk part inside, the state carried
between chunks. ``mamba_block`` sends its SSD through
``kernels.ssd_scan.ops.ssd``: the CUDA SSD chunk kernel on the card, its
plain version on the CPU. That is the JAX package's ``use_pallas`` path,
taken at prefill and at decode alike (decode is a chunk of one token).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.layers import ParamDef, rms_norm


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------

def mamba_defs(cfg, ll=()) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    ns = s.d_state
    Lax = tuple("layers" for _ in ll)
    hax = "ssm_heads" if nh % 16 == 0 else "ssm_heads_rep"
    return {
        "wz": ParamDef(ll + (d, di), Lax + ("embed", hax)),
        "wx": ParamDef(ll + (d, di), Lax + ("embed", hax)),
        "wb": ParamDef(ll + (d, ns), Lax + ("embed", "ssm_state")),
        "wc": ParamDef(ll + (d, ns), Lax + ("embed", "ssm_state")),
        "wdt": ParamDef(ll + (d, nh), Lax + ("embed", hax)),
        "dt_bias": ParamDef(ll + (nh,), Lax + (hax,), init="zeros"),
        "A_log": ParamDef(ll + (nh,), Lax + (hax,), init="ones"),
        "D": ParamDef(ll + (nh,), Lax + (hax,), init="ones"),
        "conv_x": ParamDef(ll + (s.d_conv, di), Lax + ("conv", hax),
                           scale=0.5),
        "conv_b": ParamDef(ll + (s.d_conv, ns), Lax + ("conv", "ssm_state"),
                           scale=0.5),
        "conv_c": ParamDef(ll + (s.d_conv, ns), Lax + ("conv", "ssm_state"),
                           scale=0.5),
        "norm": ParamDef(ll + (di,), Lax + (hax,), init="ones"),
        "wo": ParamDef(ll + (di, d), Lax + (hax, "embed")),
    }


# ---------------------------------------------------------------------------
# Causal depthwise conv (d_conv taps) as shifted adds — no conv primitive
# ---------------------------------------------------------------------------

def causal_conv(u, w, state=None):
    """u: (B, S, C); w: (taps, C). state: (B, taps-1, C) history or None.
    Returns (y, new_state), both in the promoted dtype of u and state (as
    ``jnp.concatenate`` promotes)."""
    taps = w.shape[0]
    if state is None:
        state = u.new_zeros((u.shape[0], taps - 1, u.shape[2]))
    dt = torch.promote_types(state.dtype, u.dtype)
    ext = torch.cat([state.to(dt), u.to(dt)], dim=1)      # (B, S+taps-1, C)
    S = u.shape[1]
    y = ext[:, 0:S] * w[0]
    for i in range(1, taps):
        y = y + ext[:, i:i + S] * w[i]
    return y, ext[:, -(taps - 1):]


# ---------------------------------------------------------------------------
# SSD core (plain)
# ---------------------------------------------------------------------------

def ssd_chunked(x, dt, A_log, B_, C_, D_, chunk: int, state=None,
                return_state: bool = False, einsum_dtype=torch.float32):
    """x: (B,S,nh,hp); dt: (B,S,nh) (post-softplus); A_log: (nh,);
    B_/C_: (B,S,ns) (single group shared by all heads); D_: (nh,).
    state: (B,nh,hp,ns) initial inter-chunk state. ``einsum_dtype`` rounds
    the intra-chunk einsum inputs (JAX: bf16 operands, fp32 products). The
    chunk's prefix sum cs is accumulated in fp64 and its differences
    rounded to fp32, as in the CUDA SSD kernel (``csrc/ssd_chunk.cu``)."""
    B, S, nh, hp = x.shape
    ns = B_.shape[-1]
    cl = min(chunk, S)
    S_orig = S
    if S % cl:                 # pad with dt=0 tokens: no state contribution
        pad = cl - S % cl
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, pad))
        S = S + pad
    nc = S // cl
    A = -torch.exp(A_log.float())                          # (nh,)
    dtf = dt.float()
    dA = (dtf * A).reshape(B, nc, cl, nh)
    xdt = (x.float() * dtf[..., None]).reshape(B, nc, cl, nh, hp)
    Bc = B_.float().reshape(B, nc, cl, ns)
    Cc = C_.float().reshape(B, nc, cl, ns)

    def rnd(t):                # einsum operands rounded to einsum_dtype
        return t.to(einsum_dtype).float()

    tri = torch.ones((cl, cl), dtype=torch.bool, device=x.device).tril()
    if state is None:
        state = torch.zeros((B, nh, hp, ns), dtype=torch.float32,
                            device=x.device)
    ys = []
    for c in range(nc):
        dA_k, x_k, B_k, C_k = dA[:, c], xdt[:, c], Bc[:, c], Cc[:, c]
        cs = torch.cumsum(dA_k.double(), dim=1)            # (B,cl,nh)
        seg = (cs[:, :, None, :] - cs[:, None, :, :]).float()
        # mask BEFORE exp: exp of masked (positive) entries overflows
        seg = torch.where(tri[None, :, :, None], seg, -1e9)
        L = rnd(torch.exp(seg))
        sc = rnd(torch.einsum("bin,bjn->bij", rnd(C_k), rnd(B_k)))
        y_diag = torch.einsum("bijh,bjhp->bihp", sc[..., None] * L,
                              rnd(x_k))
        dec_in = torch.exp(cs.float())                     # (B,cl,nh)
        y_off = torch.einsum("bin,bhpn,bih->bihp", C_k, state, dec_in)
        total = cs[:, -1, :]                               # (B,nh)
        dec_out = torch.exp((total[:, None, :] - cs).float())
        st_new = torch.einsum("bjn,bjh,bjhp->bhpn", B_k, dec_out, x_k)
        state = state * torch.exp(total.float())[:, :, None, None] + st_new
        ys.append(y_diag + y_off)
    y = torch.stack(ys, dim=1).reshape(B, S, nh, hp)
    y = y + x.float() * D_.float()[None, None, :, None]
    y = y.to(x.dtype)[:, :S_orig]
    return (y, state) if return_state else y


def ssd_decode_step(x, dt, A_log, B_, C_, D_, state):
    """Single-token recurrence. x: (B,nh,hp); dt: (B,nh); B_/C_: (B,ns);
    state: (B,nh,hp,ns) → (y, new_state)."""
    A = -torch.exp(A_log.float())
    dtf = dt.float()
    dA = torch.exp(dtf * A)                                # (B,nh)
    xf = x.float()
    upd = torch.einsum("bhp,bn->bhpn", xf * dtf[..., None], B_.float())
    state = state * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state, C_.float())
    y = y + xf * D_.float()[None, :, None]
    return y.to(x.dtype), state


# ---------------------------------------------------------------------------
# Full Mamba2 block
# ---------------------------------------------------------------------------

def mamba_block(cfg, p, u, dtype, *, state=None, conv_state=None,
                return_state: bool = False):
    """u: (B, S, D). ``state``/``conv_state`` continue a sequence (decode
    passes one token); None starts one."""
    s = cfg.ssm
    B, S, D = u.shape
    di = s.d_inner(D)
    nh = s.n_heads(D)

    z = u @ p["wz"].to(dtype)
    xs = u @ p["wx"].to(dtype)
    bs = u @ p["wb"].to(dtype)
    cs = u @ p["wc"].to(dtype)
    dt = F.softplus((u @ p["wdt"].to(dtype)).float() + p["dt_bias"].float())

    cx = cb = cc = None
    if conv_state is not None:
        cx, cb, cc = conv_state
    xs, cx = causal_conv(xs, p["conv_x"].to(dtype), cx)
    bs, cb = causal_conv(bs, p["conv_b"].to(dtype), cb)
    cs2, cc = causal_conv(cs, p["conv_c"].to(dtype), cc)
    xs = F.silu(xs)
    bs = F.silu(bs)
    cs2 = F.silu(cs2)

    xh = xs.reshape(B, S, nh, s.headdim)
    chunk = cfg.ssm_chunk or s.chunk
    y, new_state = ssd_ops.ssd(xh, dt, p["A_log"], bs, cs2, p["D"],
                               chunk=chunk, state=state)
    y = y.reshape(B, S, di)
    # gated RMSNorm (Mamba2): norm(y * silu(z))
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["wo"].to(dtype)
    if return_state:
        return out, new_state, (cx, cb, cc)
    return out


def mamba_decode_block(cfg, p, u, state, conv_state, dtype):
    """u: (B, 1, D) single step."""
    return mamba_block(cfg, p, u, dtype, state=state, conv_state=conv_state,
                       return_state=True)
