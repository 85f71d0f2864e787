"""The model module of the benchmark's configurations that name none
(``reference/__init__.py``): DeepSeek-V2's and Mixtral's blocks as the
program states them. It gives their leaves, the matrix parameters a
token multiplies in a layer, and the fp32 reference forward and loss.

The reference follows the configuration as the program states it
(``assumed`` in the configuration's file): rms norms, rotate-half RoPE,
causal attention (MLA decompressed: q/k 192, v 128; or GQA), SwiGLU, and
MoE with top-k gates renormalised to sum to one, a capacity of
``capacity(tokens of the group)`` slots an expert in each routing group,
slots taken in token order and those past it dropped, and shared experts
always on (routing groups and ``Prec``: ``reference/common.py``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch

from bench.reference.common import (Prec, attend, capacity, layer_list,
                                    prefill_groups, rms_norm, rope, swiglu,
                                    unit_groups)


def block_leaves(m: dict, moe_layer: bool) -> List[Tuple[Tuple[str, ...],
                                                        tuple, bool, bool]]:
    """One layer's leaves in the program's tree: (path within the layer,
    shape, a norm scale of ones?, read in fp32 when served in bf16?)."""
    d, H = m["d_model"], m["n_heads"]
    out = [(("ln1",), (d,), True, True), (("ln2",), (d,), True, True)]
    if m.get("mla"):
        a = m["mla"]
        qk = a["qk_nope_head_dim"] + a["qk_rope_head_dim"]
        lora = a["kv_lora_rank"]
        out += [(("attn", "wq"), (d, H * qk), False, False),
                (("attn", "wdkv"), (d, lora + a["qk_rope_head_dim"]), False,
                 False),
                (("attn", "ckv_norm"), (lora,), True, True),
                (("attn", "wuk"), (lora, H * a["qk_nope_head_dim"]), False,
                 False),
                (("attn", "wuv"), (lora, H * a["v_head_dim"]), False, False),
                (("attn", "wo"), (H * a["v_head_dim"], d), False, False)]
    else:
        hd, KH = m["head_dim"], m["n_kv_heads"]
        out += [(("attn", "wq"), (d, H * hd), False, False),
                (("attn", "wk"), (d, KH * hd), False, False),
                (("attn", "wv"), (d, KH * hd), False, False),
                (("attn", "wo"), (H * hd, d), False, False)]
    if moe_layer:
        e = m["moe"]
        split = e.get("expert_split", 1)
        Ee, f = e["n_experts"] * split, e["d_ff_expert"] // split
        out += [(("moe", "router"), (d, e["n_experts"]), False, True),
                (("moe", "w1"), (Ee, d, f), False, False),
                (("moe", "w3"), (Ee, d, f), False, False),
                (("moe", "w2"), (Ee, f, d), False, False)]
        if e.get("n_shared"):
            fs = e["d_ff_expert"] * e["n_shared"]
            out += [(("moe", "shared_w1"), (d, fs), False, False),
                    (("moe", "shared_w3"), (d, fs), False, False),
                    (("moe", "shared_w2"), (fs, d), False, False)]
    else:
        f = m["d_ff"]
        out += [(("mlp", "w1"), (d, f), False, False),
                (("mlp", "w3"), (d, f), False, False),
                (("mlp", "w2"), (f, d), False, False)]
    return out


def layer_matmul_params(m: dict, moe_layer: bool) -> int:
    """Parameters one token multiplies in one layer: the attention's
    projections and, in an MoE layer, the router, the top-k routed experts
    and the shared ones (else the dense MLP)."""
    d, H = m["d_model"], m["n_heads"]
    if m.get("mla"):
        a = m["mla"]
        qk = a["qk_nope_head_dim"] + a["qk_rope_head_dim"]
        attn = (d * H * qk + d * (a["kv_lora_rank"] + a["qk_rope_head_dim"])
                + a["kv_lora_rank"] * H * (a["qk_nope_head_dim"]
                                           + a["v_head_dim"])
                + H * a["v_head_dim"] * d)
    else:
        hd, KH = m["head_dim"], m["n_kv_heads"]
        attn = 2 * d * H * hd + 2 * d * KH * hd
    if moe_layer:
        e = m["moe"]
        ffn = (d * e["n_experts"]
               + (e["top_k"] + e.get("n_shared", 0)) * 3 * d
               * e["d_ff_expert"])
    else:
        ffn = 3 * d * m["d_ff"]
    return attn + ffn


def attention(m, p, x, pos, prec):
    B, T, _ = x.shape
    H, eps, theta = m["n_heads"], m["norm_eps"], m["rope_theta"]
    if m.get("mla"):
        a = m["mla"]
        nope, rd, vd = (a["qk_nope_head_dim"], a["qk_rope_head_dim"],
                        a["v_head_dim"])
        lora = a["kv_lora_rank"]
        q = prec.mm(x, p["wq"]).view(B, T, H, nope + rd)
        q = torch.cat([q[..., :nope], rope(q[..., nope:], pos, theta)], -1)
        dkv = prec.mm(x, p["wdkv"])
        ckv = rms_norm(dkv[..., :lora], p["ckv_norm"], eps)
        kr = rope(dkv[..., None, lora:], pos, theta)
        kn = prec.mm(ckv, p["wuk"]).view(B, T, H, nope)
        v = prec.mm(ckv, p["wuv"]).view(B, T, H, vd)
        k = torch.cat([kn, kr.expand(B, T, H, rd)], -1)
        y = attend(q, k, v, 1.0 / math.sqrt(nope + rd), prec)
        return prec.mm(y.reshape(B, T, H * vd), p["wo"])
    hd, KH = m["head_dim"], m["n_kv_heads"]
    q = rope(prec.mm(x, p["wq"]).view(B, T, H, hd), pos, theta)
    k = rope(prec.mm(x, p["wk"]).view(B, T, KH, hd), pos, theta)
    v = prec.mm(x, p["wv"]).view(B, T, KH, hd)
    y = attend(q, k, v, 1.0 / math.sqrt(hd), prec)
    return prec.mm(y.reshape(B, T, H * hd), p["wo"])


def route(e: dict, router, x, gid, okey):
    """Routing of tokens x (N, D) in groups ``gid`` (N,) taken in the order
    ``okey``: (probs (N, E), ids (N, K), gates (N, K), keep (N, K))."""
    E, K = e["n_experts"], e["top_k"]
    probs = torch.softmax(x @ router, -1)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[:, :K], ids[:, :K]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    with torch.no_grad():
        N = x.shape[0]
        k = torch.arange(K, device=x.device)
        key1 = ((gid[:, None] * N + okey[:, None]) * K + k[None]).reshape(-1)
        order = torch.argsort(key1)
        g_s, e_s = gid.repeat_interleave(K)[order], ids.reshape(-1)[order]
        key2 = g_s * E + e_s
        o2 = torch.argsort(key2, stable=True)
        k2 = key2[o2]
        first = torch.searchsorted(k2, k2)
        rank_s = torch.empty_like(first)
        rank_s[o2] = torch.arange(k2.numel(), device=x.device) - first
        rank = torch.empty_like(rank_s)
        rank[order] = rank_s
        sizes = torch.bincount(gid)
        cap = torch.tensor([capacity(e, int(n)) for n in sizes.tolist()],
                           device=x.device)
        keep = rank.view(-1, K) < cap[gid][:, None]
    return probs, ids, gates, keep


def moe(m, p, x, gid, okey, prec, with_aux=False):
    """The MoE layer over tokens x (N, D): (y, aux loss or None)."""
    e = m["moe"]
    split = e.get("expert_split", 1)
    probs, ids, gates, keep = route(e, p["router"], x, gid, okey)
    y = torch.zeros_like(x)
    for ee in range(e["n_experts"] * split):
        tok, kk = torch.nonzero((ids == ee // split) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        out = swiglu(x[tok], p["w1"][ee], p["w3"][ee], p["w2"][ee], prec)
        y = y.index_add(0, tok, out * gates[tok, kk][:, None])
    if e.get("n_shared"):
        y = y + swiglu(x, p["shared_w1"], p["shared_w3"], p["shared_w2"],
                       prec)
    aux = None
    if with_aux:
        E, K = e["n_experts"], e["top_k"]
        ng = int(gid.max()) + 1
        sizes = torch.bincount(gid, minlength=ng).float()
        cnt = torch.zeros(ng * E, device=x.device).index_add(
            0, (gid[:, None] * E + ids).reshape(-1),
            keep.reshape(-1).float()).view(ng, E)
        frac = cnt / (sizes[:, None] * K)
        imp = torch.zeros(ng, E, device=x.device).index_add(0, gid, probs) \
            / sizes[:, None]
        aux = E * (frac * imp).sum(-1).mean() * e["router_aux_weight"]
    return y, aux


def block(m, p, h, pos, gid, okey, prec, moe_layer, with_aux=False):
    """One layer over a (B, T, D) batch; returns (h, aux or None)."""
    eps = m["norm_eps"]
    h = h + attention(m, p["attn"], rms_norm(h, p["ln1"], eps), pos, prec)
    x = rms_norm(h, p["ln2"], eps)
    B, T, D = x.shape
    if moe_layer:
        f, aux = moe(m, p["moe"], x.reshape(-1, D), gid.reshape(-1),
                     okey.reshape(-1), prec, with_aux)
        return h + f.view(B, T, D), aux
    mp = p["mlp"]
    return h + swiglu(x, mp["w1"], mp["w3"], mp["w2"], prec), None


@torch.no_grad()
def serve_logits(m: dict, layer_weights: Callable, top_weights: Dict,
                 units: List[dict], prec: Prec, device) -> List[torch.Tensor]:
    """Logits (fp32) of each unit at its ``score`` positions.

    Each unit is a generate: ``tokens`` (B, T) (the prompt of ``S0`` then
    the served tokens but the last), ``S0``, and ``score`` the positions
    whose logits served a token. ``layer_weights(stack, i)`` gives one
    layer's fp32 weights, ``top_weights`` the embedding, final norm and
    head. The layers run one at a time over all the units, and the MoE
    layer routes all their tokens at once (their groups kept apart)."""
    hs, meta, base = [], [], 0
    for u in units:
        tok = torch.as_tensor(u["tokens"], device=device).long()
        B, T = tok.shape
        gid, okey = unit_groups(B, u["S0"], T, device)
        meta.append((torch.arange(T, device=device), gid + base, okey))
        base += int(gid.max()) + 1
        hs.append(top_weights["embed"][tok])
    for stack, i, moe_layer in layer_list(m):
        p = layer_weights(stack, i)
        eps = m["norm_eps"]
        for j, (pos, _, _) in enumerate(meta):
            hs[j] = hs[j] + attention(m, p["attn"],
                                      rms_norm(hs[j], p["ln1"], eps), pos,
                                      prec)
        xs = [rms_norm(h, p["ln2"], eps) for h in hs]
        if moe_layer:
            D = m["d_model"]
            flat = torch.cat([x.reshape(-1, D) for x in xs])
            f, _ = moe(m, p["moe"], flat,
                       torch.cat([g.reshape(-1) for _, g, _ in meta]),
                       torch.cat([o.reshape(-1) for _, _, o in meta]), prec)
            n0 = 0
            for j, x in enumerate(xs):
                n = x.shape[0] * x.shape[1]
                hs[j] = hs[j] + f[n0:n0 + n].view_as(x)
                n0 += n
        else:
            mp = p["mlp"]
            for j, x in enumerate(xs):
                hs[j] = hs[j] + swiglu(x, mp["w1"], mp["w3"], mp["w2"], prec)
        del p, xs
    out = []
    for u, h in zip(units, hs):
        rows = h[:, u["score"]]
        x = rms_norm(rows, top_weights["final_norm"], m["norm_eps"])
        out.append(prec.mm(x, top_weights["head"]))
    return out


def loss(m: dict, params: Dict, tokens, labels, prec: Prec,
         remat: bool = True) -> torch.Tensor:
    """The training loss of a (B, S) batch: the mean cross-entropy over
    every position plus the MoE layers' load-balance terms. ``params``
    maps (stack, i) to one layer's tree and holds "embed", "final_norm",
    "head"; each layer is recomputed in the backward when ``remat``."""
    B, S = tokens.shape
    dev = tokens.device
    pos = torch.arange(S, device=dev)
    gid, okey = prefill_groups(B, S, dev)
    h = params["embed"][tokens.long()]
    auxs = []
    for stack, i, moe_layer in layer_list(m):
        p = params[(stack, i)]

        def body(h, p=p, moe_layer=moe_layer):
            h, aux = block(m, p, h, pos, gid, okey, prec, moe_layer,
                           with_aux=moe_layer)
            return h, (aux if aux is not None else h.new_zeros(()))
        if remat and torch.is_grad_enabled():
            h, aux = torch.utils.checkpoint.checkpoint(body, h,
                                                       use_reentrant=False)
        else:
            h, aux = body(h)
        if moe_layer:
            auxs.append(aux)
    x = rms_norm(h, params["final_norm"], m["norm_eps"])
    logits = prec.mm(x, params["head"])
    ce = (torch.logsumexp(logits, -1)
          - logits.gather(-1, labels.long()[..., None])[..., 0]).mean()
    return ce + (torch.stack(auxs).sum() if auxs else 0.0)
