"""Model assembly, dense / ssm / hybrid families (``mesh=None`` path of
``repro.models.lm``).

``param_defs(cfg)`` declares the parameter tree with the JAX package's
shapes (layers stacked on a leading axis); ``forward`` / ``prefill_cache``
/ ``decode_step`` consume it as a plain dict of tensors. Where JAX runs
``lax.scan`` over the stacked layers, the port loops in Python over views
of the stacked tensors. ``LM`` is an ``nn.Module`` that holds such a tree.

Prefill attention goes through ``attention.flash_attention`` (the CUDA
flash kernel on the card). Decode attention goes through the paged decode
op (the CUDA paged kernel on the card): each layer's dense cache
``(B, Smax, KH, hd)`` is viewed, without a copy, as a page pool
``(B·Smax/P, P, KH, hd)`` with an identity page table. Every Mamba2 layer
(``ssm``: mamba2-130m; ``hybrid``: zamba2-2.7b, whose one tied attention
block follows every ``attn_every`` Mamba2 layers) runs its SSD through the
CUDA SSD chunk kernel on the card, at prefill and at decode.

Training differentiates ``forward``: attention through the flash
kernels' ``FlashAttention`` function, and with ``cfg.remat`` each layer
is rematerialised in the backward (``_maybe_remat``). On the card only
the dense family trains: the SSD kernel has no backward yet, and its op
raises when a gradient is needed (ROADMAP.md Queue 1); on the CPU every
family differentiates through the plain versions.

The moe, vlm and audio families raise ``NotImplementedError``: they come
in later slices of the port (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch import resolve_device
from repro_torch.kernels.paged_attn import ops as _paged_ops
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mam
from repro_torch.models.layers import (ParamDef, apply_rope, materialize,
                                       mlp_apply, mlp_defs, padded_vocab,
                                       rms_norm, rope_cos_sin, tree_map_defs)

PAGE_SIZE = 16          # tokens per page of the decode op's pool view
_CONV = ("conv_x", "conv_b", "conv_c")

_LATER = "ROADMAP.md Queue 1, item 4 (MoE/MLA/vlm/audio)"


def _require_ported(cfg):
    if cfg.family not in ("dense", "ssm", "hybrid") or cfg.mla is not None \
            or cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.arch_id}: the {cfg.family!r} family is not ported yet; "
            f"see {_LATER}")


# ---------------------------------------------------------------------------
# Parameter declaration
# ---------------------------------------------------------------------------

def _attn_defs(cfg, ll=()) -> dict:
    d, H, KH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    Lax = tuple("layers" for _ in ll)
    return {
        "wq": ParamDef(ll + (d, H * hd), Lax + ("embed", "heads")),
        "wk": ParamDef(ll + (d, KH * hd), Lax + ("embed", "kv_heads")),
        "wv": ParamDef(ll + (d, KH * hd), Lax + ("embed", "kv_heads")),
        "wo": ParamDef(ll + (H * hd, d), Lax + ("heads", "embed")),
    }


def _block_defs(cfg, ll=()) -> dict:
    d = cfg.d_model
    Lax = tuple("layers" for _ in ll)
    return {
        "ln1": ParamDef(ll + (d,), Lax + ("embed",), init="ones"),
        "ln2": ParamDef(ll + (d,), Lax + ("embed",), init="ones"),
        "attn": _attn_defs(cfg, ll),
        "mlp": mlp_defs(cfg, cfg.d_ff, ll=ll),
    }


def param_defs(cfg) -> dict:
    _require_ported(cfg)
    d = cfg.d_model
    V = padded_vocab(cfg.vocab_size)
    defs: Dict[str, Any] = {
        "embed": ParamDef((V, d), ("vocab", "embed")),
        "final_norm": ParamDef((d,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((d, V), ("embed", "vocab"))
    if cfg.family == "dense":
        defs["layers"] = _block_defs(cfg, (cfg.n_layers,))
    else:
        defs["layers"] = mam.mamba_defs(cfg, ll=(cfg.n_layers,))
    if cfg.family == "hybrid":
        defs["shared_attn"] = _block_defs(cfg, ())
    return defs


def _apply_param_dtype(cfg, defs):
    """Honor cfg.param_dtype (fp32 leaves take it)."""
    if cfg.param_dtype == "float32":
        return defs
    return tree_map_defs(
        lambda pd: dataclasses.replace(pd, dtype=cfg.param_dtype)
        if pd.dtype == "float32" else pd, defs)


def init_params(cfg, generator: torch.Generator, *, device="cuda") -> dict:
    """Random parameters from ``generator`` (which lives on ``device``)."""
    dev = resolve_device(device)
    return materialize(_apply_param_dtype(cfg, param_defs(cfg)), generator,
                       device=dev)


# leaves the model reads in fp32 (rms_norm scales; the Mamba2 A_log, D,
# dt_bias and gated-norm scale): casting them would change their values
_FP32_LEAVES = ("ln1", "ln2", "final_norm", "A_log", "D", "dt_bias", "norm")


def cast_params(cfg, params: dict, dtype) -> dict:
    """The tree with every matrix cast to ``dtype`` once. Each use casts
    these leaves to the compute dtype anyway (``w.to(dtype)``), so the
    values seen by the model are identical; the leaves the model reads in
    fp32 are left as they are. Serving uses this so a decode step does not
    re-read and re-cast every fp32 weight."""
    def walk(tree):
        return {k: (walk(v) if isinstance(v, dict)
                    else v if k in _FP32_LEAVES else v.to(dtype))
                for k, v in tree.items()}
    return walk(params)


class LM(nn.Module):
    """Holds a ``param_defs(cfg)`` tree as (frozen) parameters, nested as
    submodules with the tree's keys; ``param_tree()`` gives the dict back."""

    def __init__(self, cfg, params: dict):
        super().__init__()
        _require_ported(cfg)
        self.cfg = cfg
        self._tree = _to_module(params)

    def param_tree(self) -> dict:
        return _from_module(self._tree)

    def forward(self, tokens, *, collect_cache: bool = False):
        return forward(self.cfg, self.param_tree(), {"tokens": tokens},
                       collect_cache=collect_cache)


def _to_module(tree: dict) -> nn.Module:
    mod = nn.Module()
    for k, v in tree.items():
        if isinstance(v, dict):
            mod.add_module(k, _to_module(v))
        else:
            mod.register_parameter(k, nn.Parameter(v, requires_grad=False))
    return mod


def _from_module(mod: nn.Module) -> dict:
    out = {k: p for k, p in mod.named_parameters(recurse=False)}
    out.update({k: _from_module(m) for k, m in mod.named_children()})
    return out


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(cfg, params, tokens, dtype):
    # gather first, then cast: the same values as casting the whole table
    return params["embed"][tokens.long()].to(dtype)


def lm_head(cfg, params, x, dtype):
    w = params["embed"].to(dtype).t() if cfg.tie_embeddings \
        else params["head"].to(dtype)
    return x @ w


# ---------------------------------------------------------------------------
# Transformer block (prefill)
# ---------------------------------------------------------------------------

def _layers(stacked: dict, cast=None) -> list:
    """Every layer's views of the stacked tree (JAX: the scan's slices),
    by one ``unbind`` a leaf: its backward stacks the layers' gradients
    once, where a ``stacked[i]`` a layer would make each layer's gradient
    a full stacked-size tensor and sum all of them. With ``cast``, fp32
    leaves are cast to it (``cfg.bf16_stacked_params``)."""
    def split(a):
        return [p.to(cast) if cast is not None and p.dtype == torch.float32
                else p for p in a.unbind(0)]
    per_key = {k: _layers(v, cast) if isinstance(v, dict) else split(v)
               for k, v in stacked.items()}
    n = len(next(iter(per_key.values())))
    return [{k: v[i] for k, v in per_key.items()} for i in range(n)]


def _transformer_block(cfg, p, x, cos, sin, dtype, *,
                       collect_cache: bool = False):
    B, S, D = x.shape
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    pa = p["attn"]
    q = (h @ pa["wq"].to(dtype)).reshape(B, S, H, hd)
    k = (h @ pa["wk"].to(dtype)).reshape(B, S, KH, hd)
    v = (h @ pa["wv"].to(dtype)).reshape(B, S, KH, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    cache = (k, v) if collect_cache else None
    o = attn.flash_attention(q, k, v, causal=True, window=cfg.swa_window,
                             q_chunk=cfg.attn_q_chunk,
                             scale=1.0 / math.sqrt(hd),
                             schedule=cfg.attn_schedule)
    y = o.reshape(B, S, H * hd) @ pa["wo"].to(dtype)
    x = x + y
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_apply(cfg, p["mlp"], h2, dtype), 0.0, cache


# ---------------------------------------------------------------------------
# Forward (train & prefill share this; prefill also returns the KV cache)
# ---------------------------------------------------------------------------

def _maybe_remat(cfg):
    """How a layer's body runs: with ``cfg.remat`` and grad enabled, under
    ``torch.utils.checkpoint`` (only the body's inputs are kept; its
    activations are recomputed in the backward), the counterpart of
    ``jax.checkpoint(policy=nothing_saveable)`` at
    ``repro/models/lm.py:231-235``. The JAX package remats the scan body:
    a layer, or in the hybrid family a group of ``attn_every`` Mamba2
    layers with the tied block; the port remats each layer and each tied
    block application, which computes the same values."""
    if cfg.remat and torch.is_grad_enabled():
        return lambda fn, *args: torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False)
    return lambda fn, *args: fn(*args)


def forward(cfg, params, batch, *, collect_cache: bool = False):
    """batch: dict with 'tokens' (B, S).

    Returns (logits (B, S, V_padded), aux_loss, caches_or_None). With
    ``collect_cache`` the caches hold "kv": (k, v), each (G, B, S, KH, hd)
    for the G attention applications. The ssm and hybrid families always
    return their per-layer "ssm" (L, B, nh, hp, ns) and "conv_x/b/c"
    (L, B, d_conv-1, C) states (``repro/models/lm.py:381-382``)."""
    _require_ported(cfg)
    dtype = cfg.compute_dt()
    tokens = batch["tokens"]
    B, S = tokens.shape[:2]
    x = embed_tokens(cfg, params, tokens, dtype)
    fam = cfg.family
    cos = sin = None
    if fam != "ssm":
        cos, sin = rope_cos_sin(torch.arange(S, device=x.device), cfg.hd,
                                cfg.rope_theta)
    layers = _layers(params["layers"],
                     dtype if cfg.bf16_stacked_params else None)
    run = _maybe_remat(cfg)
    ks, vs, states, convs = [], [], [], []

    def attn_body(p, x):
        x, _, kv = _transformer_block(cfg, p, x, cos, sin, dtype,
                                      collect_cache=collect_cache)
        return x, kv

    def attend(p, x):
        x, kv = run(attn_body, p, x)
        if collect_cache:
            ks.append(kv[0])
            vs.append(kv[1])
        return x

    def mamba_body(p_l, x):
        y, st, conv = mam.mamba_block(cfg, p_l, x, dtype, return_state=True)
        return x + y, st, conv

    for i, p_l in enumerate(layers):
        if fam == "dense":
            x = attend(p_l, x)
            continue
        x, st, conv = run(mamba_body, p_l, x)
        states.append(st)
        convs.append(conv)
        if fam == "hybrid" and (i + 1) % cfg.attn_every == 0:
            x = attend(params["shared_attn"], x)     # the tied block
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_head(cfg, params, x, dtype)
    caches: Dict[str, Any] = {}
    if states:
        caches["ssm"] = torch.stack(states)
        for n, per_layer in zip(_CONV, zip(*convs)):
            caches[n] = torch.stack(per_layer)
    if collect_cache and ks:
        caches["kv"] = (torch.stack(ks), torch.stack(vs))
    return logits, 0.0, (caches if collect_cache or states else None)


def prefill_cache(cfg, caches, S: int) -> dict:
    """Reformat forward(collect_cache=True) output into the decode cache
    layout (same keys/shapes as cache_spec_defs). SWA archs keep the last
    ``window`` positions — with window | S these land in ring order."""
    _require_ported(cfg)
    win = cfg.swa_window

    def ring(t):                       # t: (L,B,S,KH,hd)
        if win and t.shape[2] > win:
            t = t[:, :, -win:]
        return t.to(torch.bfloat16)

    out = {}
    if cfg.family in ("ssm", "hybrid"):
        out["ssm"] = caches["ssm"].float()
        for n in _CONV:
            out[n] = caches[n].to(torch.bfloat16)
    if cfg.family in ("dense", "hybrid"):
        k, v = caches["kv"]
        out["k"], out["v"] = ring(k), ring(v)
    return out


# ---------------------------------------------------------------------------
# Decode (serve_step): one token against the KV cache / SSM state
# ---------------------------------------------------------------------------

def cache_spec_defs(cfg, max_len: int, batch: int) -> dict:
    _require_ported(cfg)
    KH, hd = cfg.n_kv_heads, cfg.hd
    L = cfg.n_layers
    win = cfg.swa_window
    S = min(max_len, win) if win else max_len
    fam = cfg.family
    defs: Dict[str, Any] = {}
    if fam in ("ssm", "hybrid"):
        s = cfg.ssm
        di, nh, ns = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model), \
            s.d_state
        hax = "ssm_heads" if nh % 16 == 0 else "ssm_heads_rep"
        defs["ssm"] = ParamDef((L, batch, nh, s.headdim, ns),
                               ("layers", "batch", hax, None, "ssm_state"),
                               dtype="float32")
        defs["conv_x"] = ParamDef((L, batch, s.d_conv - 1, di),
                                  ("layers", "batch", None, hax),
                                  dtype="bfloat16")
        for n in ("conv_b", "conv_c"):
            defs[n] = ParamDef((L, batch, s.d_conv - 1, ns),
                               ("layers", "batch", None, "ssm_state"),
                               dtype="bfloat16")
    if fam in ("dense", "hybrid"):
        G = L if fam == "dense" else L // cfg.attn_every
        ax = ("layers", "batch", "kv_seq", "kv_heads", None)
        defs["k"] = ParamDef((G, batch, S, KH, hd), ax, dtype="bfloat16")
        defs["v"] = ParamDef((G, batch, S, KH, hd), ax, dtype="bfloat16")
    return defs


def init_cache(cfg, max_len, batch, *, device="cuda") -> dict:
    """Zero cache (bf16 k/v and conv states, fp32 ssm state); a k/v
    cache's sequence length must be a whole number of decode pages
    (``PAGE_SIZE``)."""
    dev = resolve_device(device)
    defs = cache_spec_defs(cfg, max_len, batch)
    if "k" in defs and defs["k"].shape[2] % PAGE_SIZE:
        raise ValueError(f"cache length {defs['k'].shape[2]} is not a "
                         f"multiple of the decode page size {PAGE_SIZE}")
    return {n: torch.zeros(pd.shape, dtype=getattr(torch, pd.dtype),
                           device=dev) for n, pd in defs.items()}


def grow_cache(cfg, cache, max_len) -> dict:
    """The prefill cache (``prefill_cache``, sized to the prompt) in a zero
    cache of ``max_len`` positions on the same device, for decode: k/v grow
    along the sequence; the SSM and conv states carry as they are."""
    some = next(iter(cache.values()))
    full = init_cache(cfg, max_len, some.shape[1], device=some.device)
    for n, t in cache.items():
        if t.shape == full[n].shape:
            full[n] = t
        else:
            full[n][tuple(slice(0, s) for s in t.shape)] = t
    return full


def identity_pages(B, Smax, pos, window, device):
    """Page table and lengths that make the paged op read a dense cache:
    row b is pages b·(Smax/P) + j for the pages holding positions <= pos
    (ring order for a window cache), lengths = pos + 1 (<= Smax)."""
    per_seq = Smax // PAGE_SIZE
    length = min(pos + 1, Smax) if window else pos + 1
    nblk = -(-length // PAGE_SIZE)
    table = (torch.arange(B, device=device, dtype=torch.int32)[:, None]
             * per_seq
             + torch.arange(nblk, device=device, dtype=torch.int32)[None])
    lengths = torch.full((B,), length, dtype=torch.int32, device=device)
    return table, lengths


def _decode_attn_block(cfg, p, x, kc, vc, pos, cos, sin, dtype, pages):
    """x: (B,1,D); kc/vc: (B,S,KH,hd) views of one layer of the cache,
    updated in place (JAX donates the cache to the step instead)."""
    B = x.shape[0]
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    Smax = kc.shape[1]
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    pa = p["attn"]
    q = (h @ pa["wq"].to(dtype)).reshape(B, 1, H, hd)
    k = (h @ pa["wk"].to(dtype)).reshape(B, 1, KH, hd)
    v = (h @ pa["wv"].to(dtype)).reshape(B, 1, KH, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    idx = pos % Smax if cfg.swa_window else pos
    kc[:, idx] = k[:, 0].to(kc.dtype)
    vc[:, idx] = v[:, 0].to(vc.dtype)
    # JAX (lm.py:507): decode_attention(q, kc.astype(dtype), ...). Here the
    # same cache, cast to the compute dtype (a no-op for bf16), is viewed
    # as a page pool and read by the paged op through an identity table.
    n_pages = B * Smax // PAGE_SIZE
    pool_k = kc.to(dtype).view(n_pages, PAGE_SIZE, KH, hd)
    pool_v = vc.to(dtype).view(n_pages, PAGE_SIZE, KH, hd)
    table, lengths = pages
    o = _paged_ops.paged_attention(q[:, 0], pool_k, pool_v, table, lengths,
                                   scale=1.0 / math.sqrt(hd))
    y = o.reshape(B, H * hd) @ pa["wo"].to(dtype)
    return x + y[:, None]


def _decode_ffn(cfg, p, x, dtype):
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_apply(cfg, p["mlp"], h2, dtype)


def decode_step(cfg, params, cache, tokens, pos: int):
    """One decode step. tokens: (B,1) int; pos: the new token's position.
    Writes the token's K/V and each layer's new SSM and conv state into
    ``cache`` in place and returns (logits (B, V_padded), cache)."""
    _require_ported(cfg)
    dtype = cfg.compute_dt()
    pos = int(pos)
    B = tokens.shape[0]
    x = embed_tokens(cfg, params, tokens, dtype)           # (B,1,D)
    dev = x.device
    fam = cfg.family
    if fam != "ssm":
        cos, sin = rope_cos_sin(torch.tensor([pos], device=dev), cfg.hd,
                                cfg.rope_theta)
        Smax = cache["k"].shape[2]
        if not cfg.swa_window and not 0 <= pos < Smax:
            raise ValueError(f"position {pos} is outside the cache ({Smax})")
        pages = identity_pages(B, Smax, pos, cfg.swa_window, dev)

    def attend(p, x, g):
        x = _decode_attn_block(cfg, p, x, cache["k"][g], cache["v"][g], pos,
                               cos, sin, dtype, pages)
        return _decode_ffn(cfg, p, x, dtype)

    if fam != "dense":
        # JAX replaces each conv state by the step's output, whose dtype is
        # that of concatenating the cached (bf16) state with the compute
        # dtype: fp32 compute turns the conv states fp32 from the first step
        for n in _CONV:
            want = torch.promote_types(cache[n].dtype, dtype)
            if cache[n].dtype != want:
                cache[n] = cache[n].to(want)
    for i, p_l in enumerate(_layers(params["layers"])):
        if fam == "dense":
            x = attend(p_l, x, i)
            continue
        y, st, conv = mam.mamba_decode_block(
            cfg, p_l, x, cache["ssm"][i], tuple(cache[n][i] for n in _CONV),
            dtype)
        x = x + y
        cache["ssm"][i] = st
        for n, t in zip(_CONV, conv):
            cache[n][i] = t
        if fam == "hybrid" and (i + 1) % cfg.attn_every == 0:
            x = attend(params["shared_attn"], x, i // cfg.attn_every)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_head(cfg, params, x, dtype)                # (B,1,V)
    return logits[:, 0], cache
