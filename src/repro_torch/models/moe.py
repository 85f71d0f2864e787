"""Mixture-of-Experts layer: top-k routing with capacity-bounded
scatter/gather dispatch (PyTorch counterpart of ``repro.models.moe``, its
``mesh=None`` path and its mesh path: the same names, shapes and casts).

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

from repro_torch.models import partitioning as part
from repro_torch.models.layers import ParamDef

# Production model-axis width (repro/launch/mesh.py).
MODEL_AXIS = 16


def expert_split(cfg) -> int:
    E = cfg.moe.n_experts
    return 1 if E % MODEL_AXIS == 0 else MODEL_AXIS // E


def moe_defs(cfg, ll=()) -> dict:
    """The JAX package's leaves (``repro/models/moe.py:36``), so weights
    carry over through ``interop.params_from_numpy``, with its logical
    axes: ``cfg.moe_fsdp_out`` shards the experts' FFN dim over ``data``
    (``expert_ffn``) in place of FSDP on d_model (no weight gathers)."""
    m = cfg.moe
    split = expert_split(cfg)
    d, f, E = cfg.d_model, m.d_ff_expert // split, m.n_experts * split
    Lax = tuple("layers" for _ in ll)
    if cfg.moe_fsdp_out:
        w_ax = (("experts", None, "expert_ffn"),
                ("experts", None, "expert_ffn"),
                ("experts", "expert_ffn", None))
    else:
        w_ax = (("experts", "embed", None),
                ("experts", "embed", None),
                ("experts", None, "embed"))
    defs = {
        "router": ParamDef(ll + (d, m.n_experts), Lax + ("embed", None),
                           scale=0.1),
        "w1": ParamDef(ll + (E, d, f), Lax + w_ax[0]),
        "w3": ParamDef(ll + (E, d, f), Lax + w_ax[1]),
        "w2": ParamDef(ll + (E, f, d), Lax + w_ax[2]),
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


def _dispatch(cfg, router, xg, dtype):
    """Routing and the group-local scatter of xg (B, G, Sg, D), each group
    on its own: (x_e (B, G, Ee, C, D), slot, keep, gates_e, frac, imp),
    with frac and imp (B, G, E) the load-balance terms."""
    m = cfg.moe
    B, G, Sg, D = xg.shape
    E, K = m.n_experts, m.top_k
    split = expert_split(cfg)
    Ee, Ke = E * split, K * split
    C = capacity(cfg, Sg)
    dev = xg.device
    with record_function("moe_router"):
        logits = xg.float() @ router.float()               # (B,G,Sg,E)
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
            * keep[..., None].to(xg.dtype)
        x_e = torch.zeros((B * G * rows, D), dtype=xg.dtype, device=dev) \
            .index_add(0, dest.reshape(-1), x_flat.reshape(-1, D))
        x_e = x_e.reshape(B, G, rows, D)[:, :, :Ee * C] \
            .reshape(B, G, Ee, C, D)

    # load-balance terms (Switch/GShard form, on the true experts)
    with record_function("moe_router"):
        frac_src = onehot.reshape(B, G, Sg * Ke, E, split).sum(-1) \
            if split > 1 else onehot
        frac = (frac_src * keep[..., None]).float().mean(2)  # (B,G,E)
        imp = probs.mean(2)                                  # (B,G,E)
    return x_e, slot, keep, gates_e.reshape(B, G, Sg * Ke), frac, imp


def _combine(y_e, slot, keep, gates_e, Ke, dtype):
    """Each (token, k) slot's expert output gathered back and weighted by
    its gate, summed over a token's Ke slots: (B, G, Sg, D)."""
    B, G, Ee, C, D = y_e.shape
    with record_function("moe_combine"):
        src = slot \
            + torch.arange(B * G, device=y_e.device).reshape(B, G, 1) \
            * (Ee * C)
        y_tok = y_e.reshape(B * G * Ee * C, D) \
            .index_select(0, src.reshape(-1)).reshape(B, G, -1, D)
        w = (gates_e * keep).to(dtype)
        return (y_tok * w[..., None]).reshape(B, G, -1, Ke, D).sum(3)


def moe_ffn(cfg, p, x, dtype, mesh=None, rules=None):
    """x: (B, S, D) → (y (B, S, D), aux_loss (0-d fp32)).

    On a mesh (``mesh``, ``rules``; x a DTensor) the JAX package's six
    constraints: x's groups, and the dispatch buffers, sharded on
    ``act_seq`` (group-local); the buffers flipped to ``experts`` for the
    expert products and back (``moe_impl="shard_map"`` with G ==
    MODEL_AXIS: an explicit all-to-all each way, ``distributed.a2a``);
    the output on ``act_seq``. Routing, the dispatch scatter and the
    combine gather are group-local by design: they run on each rank's
    groups (``partitioning.local_map``)."""
    m = cfg.moe
    B, S, D = x.shape
    E, Ke = m.n_experts, m.top_k * expert_split(cfg)
    G = MODEL_AXIS if (S % MODEL_AXIS == 0 and S >= 64 * MODEL_AXIS) else 1
    Sg = S // G

    def c(t, *logical):
        return part.constrain(t, mesh, *logical, rules=rules)

    # the groups' axis: sequence-sharded as JAX's; one group (a short
    # sequence) stays whole, as DTensor would otherwise split a dim of 1
    gax = "act_seq" if G > 1 else None
    xg = c(x.reshape(B, G, Sg, D), "batch", gax, None, None)
    if mesh is None:
        x_e, slot, keep, gates_e, frac, imp = _dispatch(cfg, p["router"],
                                                        xg, dtype)
    else:
        def pl(*logical):
            return part.placements_for(part.spec_for(logical, mesh, rules),
                                       mesh)
        g3 = pl("batch", gax, None)
        x_e, slot, keep, gates_e, frac, imp = part.local_map(
            lambda xg, r: _dispatch(cfg, r, xg, dtype), mesh,
            (pl("batch", gax, None, None), pl(None, None)),
            (pl("batch", gax, None, None, None), g3, g3, g3, g3, g3),
        )(xg, p["router"])
    x_e = c(x_e, "batch", gax, None, None, None)     # group-sharded

    use_sm = (cfg.moe_impl == "shard_map" and mesh is not None and
              G == MODEL_AXIS and "model" in part.axis_sizes(mesh))
    if use_sm:
        # ---- the EXPLICIT all-to-all (the paper's shuffle) ----
        from repro_torch.distributed.a2a import moe_dispatch_combine
        batch_axes = tuple(rules.get("batch", ("data",))) if rules else \
            ("data",)
        dispatch, combine = moe_dispatch_combine(mesh, batch_axes)
        x_e = dispatch(x_e)
    else:
        # dispatch all-to-all: group-sharded -> expert-sharded
        x_e = c(x_e, "batch", None, "experts", None, None)

    with record_function("moe_experts"):
        h = torch.einsum("bgecd,edf->bgecf", x_e, p["w1"].to(dtype))
        g_ = torch.einsum("bgecd,edf->bgecf", x_e, p["w3"].to(dtype))
        y_e = torch.einsum("bgecf,efd->bgecd", F.silu(h) * g_,
                           p["w2"].to(dtype))
    y_e = c(y_e, "batch", None, "experts", None, None)
    if use_sm:
        y_e = combine(y_e)
    else:
        # combine all-to-all: expert-sharded -> group-sharded
        y_e = c(y_e, "batch", gax, None, None, None)

    if mesh is None:
        y = _combine(y_e, slot, keep, gates_e, Ke, dtype)
    else:
        y = part.local_map(
            lambda y_e, slot, keep, gates_e: _combine(y_e, slot, keep,
                                                      gates_e, Ke, dtype),
            mesh, (pl("batch", gax, None, None, None), g3, g3, g3),
            pl("batch", gax, None, None))(y_e, slot, keep, gates_e)
    y = c(y.reshape(B, S, D), "batch", "act_seq", None)

    if m.n_shared:
        with record_function("moe_shared"):
            hs = x @ p["shared_w1"].to(dtype)
            gs = x @ p["shared_w3"].to(dtype)
            ys = (F.silu(hs) * gs) @ p["shared_w2"].to(dtype)
            y = y + c(ys, "batch", "act_seq", None)

    with record_function("moe_router"):
        aux = E * (frac * imp).sum(-1).mean() * m.router_aux_weight
    return y, aux
