"""Mixture-of-Experts layer: top-k routing with capacity-bounded
scatter/gather dispatch (PyTorch counterpart of ``repro.models.moe``, its
``mesh=None`` path: the same names, shapes and casts).

GShard-style group-local dispatch: the sequence is cut into ``G`` groups
(``MODEL_AXIS`` when S is a multiple of it and at least 64 groups' worth
long, else one), and routing, each slot's position within its expert
(an exclusive cumsum) and the capacity are computed per group. Tokens
past an expert's capacity are dropped (their FFN output is zero; the
residual carries them).

Expert splitting: when the experts do not divide ``MODEL_AXIS`` (mixtral:
8 experts, split 2), each expert is stored as ``split`` sub-experts of
d_ff/split hidden channels, and a token routed to an expert goes to all of
its sub-experts with the same gate. For a gated MLP that is exact: the
gating is per hidden channel, so the partial outputs sum to the whole.

The expert products are plain ``torch.einsum`` (cuBLAS on the card), as
the JAX package leaves them to XLA outside any Pallas kernel; like its
dense dispatch they multiply every expert's C slots, filled or not.

Each stage runs under a ``torch.profiler.record_function`` range
(``moe_router``, ``moe_dispatch``, ``moe_experts``, ``moe_combine``,
``moe_shared``), so a profile splits the layer's device time by stage;
without a profiler a range costs a few host microseconds.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.models.layers import ParamDef

# Production model-axis width (repro/launch/mesh.py).
MODEL_AXIS = 16


def expert_split(cfg) -> int:
    E = cfg.moe.n_experts
    return 1 if E % MODEL_AXIS == 0 else MODEL_AXIS // E


def moe_defs(cfg, ll=()) -> dict:
    """The JAX package's leaves (``repro/models/moe.py:36``), so weights
    carry over through ``interop.params_from_numpy``; the logical axes are
    those of its default (not ``moe_fsdp_out``) layout."""
    m = cfg.moe
    split = expert_split(cfg)
    d, f, E = cfg.d_model, m.d_ff_expert // split, m.n_experts * split
    Lax = tuple("layers" for _ in ll)
    defs = {
        "router": ParamDef(ll + (d, m.n_experts), Lax + ("embed", None),
                           scale=0.1),
        "w1": ParamDef(ll + (E, d, f), Lax + ("experts", "embed", None)),
        "w3": ParamDef(ll + (E, d, f), Lax + ("experts", "embed", None)),
        "w2": ParamDef(ll + (E, f, d), Lax + ("experts", None, "embed")),
    }
    if m.n_shared:
        fs = m.d_ff_expert * m.n_shared
        defs["shared_w1"] = ParamDef(ll + (d, fs), Lax + ("embed", "mlp"))
        defs["shared_w3"] = ParamDef(ll + (d, fs), Lax + ("embed", "mlp"))
        defs["shared_w2"] = ParamDef(ll + (fs, d), Lax + ("mlp", "embed"))
    return defs


def capacity(cfg, seq_len: int) -> int:
    m = cfg.moe
    c = int(seq_len * m.top_k * m.capacity_factor / m.n_experts)
    return max(8, min(((c + 7) // 8) * 8, seq_len * m.top_k))


def _top_k(probs, k):
    """``jax.lax.top_k``: the k largest, and of equal values the lower
    index first (a stable sort, descending)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def moe_ffn(cfg, p, x, dtype):
    """x: (B, S, D) → (y (B, S, D), aux_loss (0-d fp32))."""
    m = cfg.moe
    B, S, D = x.shape
    E, K = m.n_experts, m.top_k
    split = expert_split(cfg)
    Ee, Ke = E * split, K * split
    G = MODEL_AXIS if (S % MODEL_AXIS == 0 and S >= 64 * MODEL_AXIS) else 1
    Sg = S // G
    C = capacity(cfg, Sg)
    dev = x.device

    xg = x.reshape(B, G, Sg, D)
    with record_function("moe_router"):
        logits = xg.float() @ p["router"].float()          # (B,G,Sg,E)
        probs = torch.softmax(logits, dim=-1)
        gates, ids = _top_k(probs, K)                      # (B,G,Sg,K)
        gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    with record_function("moe_dispatch"):
        if split > 1:  # each assignment to every sub-expert of its expert
            ids_e = (ids[..., None] * split
                     + torch.arange(split, device=dev)).reshape(B, G, Sg, Ke)
            gates_e = gates.repeat_interleave(split, dim=-1)
        else:
            ids_e, gates_e = ids, gates

        # group-local position of each (token, k) slot within its expert:
        # an exclusive count over the slots before it, token-major
        eid = ids_e.reshape(B, G, Sg * Ke)
        onehot = F.one_hot(eid, Ee)                        # (B,G,Sg*Ke,Ee)
        pos = ((torch.cumsum(onehot, dim=2) - onehot) * onehot).sum(-1)
        keep = pos < C
        slot = eid * C + torch.clamp_max(pos, C - 1)       # (B,G,Sg*Ke)

        # scatter into (Ee·C, D) a group; a dropped slot goes to one extra
        # row that is cut off (each kept slot gets exactly one row, so the
        # sum of index_add is that row's value)
        rows = Ee * C + 1
        dest = torch.where(keep, slot, Ee * C) \
            + torch.arange(B * G, device=dev).reshape(B, G, 1) * rows
        x_flat = xg.repeat_interleave(Ke, dim=2) \
            * keep[..., None].to(x.dtype)
        x_e = torch.zeros((B * G * rows, D), dtype=x.dtype, device=dev) \
            .index_add(0, dest.reshape(-1), x_flat.reshape(-1, D))
        x_e = x_e.reshape(B, G, rows, D)[:, :, :Ee * C] \
            .reshape(B, G, Ee, C, D)

    with record_function("moe_experts"):
        h = torch.einsum("bgecd,edf->bgecf", x_e, p["w1"].to(dtype))
        g_ = torch.einsum("bgecd,edf->bgecf", x_e, p["w3"].to(dtype))
        y_e = torch.einsum("bgecf,efd->bgecd", F.silu(h) * g_,
                           p["w2"].to(dtype))

    with record_function("moe_combine"):
        src = slot \
            + torch.arange(B * G, device=dev).reshape(B, G, 1) * (Ee * C)
        y_tok = y_e.reshape(B * G * Ee * C, D) \
            .index_select(0, src.reshape(-1)).reshape(B, G, Sg * Ke, D)
        w = (gates_e.reshape(B, G, Sg * Ke) * keep).to(dtype)
        y = (y_tok * w[..., None]).reshape(B, G, Sg, Ke, D).sum(3)
        y = y.reshape(B, S, D)

    if m.n_shared:
        with record_function("moe_shared"):
            hs = x @ p["shared_w1"].to(dtype)
            gs = x @ p["shared_w3"].to(dtype)
            y = y + (F.silu(hs) * gs) @ p["shared_w2"].to(dtype)

    # load-balance auxiliary loss (Switch/GShard form, on the true experts)
    with record_function("moe_router"):
        frac_src = onehot.reshape(B, G, Sg * Ke, E, split).sum(-1) \
            if split > 1 else onehot
        frac = (frac_src * keep[..., None]).float().mean(2)  # (B,G,E)
        imp = probs.mean(2)                                  # (B,G,E)
        aux = E * (frac * imp).sum(-1).mean() * m.router_aux_weight
    return y, aux
