"""Model assembly for every family: dense / vlm / audio / moe / ssm /
hybrid (the ``mesh=None`` path of ``repro.models.lm``).

``param_defs(cfg)`` declares the parameter tree with the JAX package's
shapes (layers stacked on a leading axis); ``forward`` / ``prefill_cache``
/ ``decode_step`` consume it as a plain dict of tensors. Where JAX runs
``lax.scan`` over the stacked layers, the port loops in Python over views
of the stacked tensors. ``LM`` is an ``nn.Module`` that holds such a tree.

Prefill attention goes through ``attention.flash_attention`` (the CUDA
flash kernel on the card). Decode attention goes through the paged decode
op (the CUDA paged kernel on the card): each layer's dense cache
``(B, Smax, KH, hd)``, of any length Smax and allocated in whole pages,
is viewed, without a copy, as a page pool ``(B·ceil(Smax/P), P, KH, hd)``
with an identity page table. Every Mamba2 layer
(``ssm``: mamba2-130m; ``hybrid``: zamba2-2.7b, whose one tied attention
block follows every ``attn_every`` Mamba2 layers) runs its SSD through the
CUDA SSD chunk kernel on the card, at prefill and at decode.

The vlm family (qwen2-vl-2b) is the dense stack with M-RoPE: its forward
takes token ids or precomputed patch embeddings (``embeds``) with 3-stream
position ids (``pos3``: temporal, height, width), and a decode step at
position p rotates all three sections by p, as the JAX package does. The
audio family (musicgen-large) embeds K codebook streams (their embeddings
summed), adds an absolute sinusoidal position and has a (d, K·V) head:
tokens and logits carry a codebook axis, (B, S, K) and (B, S, K, V).

The moe family runs ``moe.moe_ffn`` in place of the MLP in its MoE
layers (mixtral-8x22b: every layer, sliding-window GQA attention;
deepseek-v2-lite-16b: after ``first_k_dense`` dense layers, the
``dense_layers`` stack). deepseek-v2-lite attends by MLA: prefill and
training through ``attention.mla_prefill`` (the flash op at q/k 192, v
128), decode through the absorbed ``attention.mla_decode`` in plain torch
over a compressed ``ckv``/``kr`` cache (no paged op, as the JAX package
has no kernel there). Decode routes the whole token batch jointly: the B
new tokens play the sequence (``(1, B, D)``).

Training differentiates ``forward``: attention through the flash
kernels' ``FlashAttention`` function, every Mamba2 layer's SSD through
``SSDChunk`` (the SSD chunk kernel and its backward kernel), and with
``cfg.remat`` each layer is rematerialised in the backward
(``_maybe_remat``). Every family trains on the CPU through the plain
versions and on the card through the kernels (MLA through the flash
backward at q/k 192, v 128).
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
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (ParamDef, apply_rope, materialize,
                                       mlp_apply, mlp_defs, mrope_cos_sin,
                                       padded_vocab, rms_norm, rope_cos_sin,
                                       sinusoidal_positions, tree_map_defs)

PAGE_SIZE = 16          # tokens per page of the decode op's pool view
_CONV = ("conv_x", "conv_b", "conv_c")
# families whose every layer is a transformer block (no Mamba2 layer)
_ATTN_ONLY = ("dense", "vlm", "audio", "moe")


# ---------------------------------------------------------------------------
# Parameter declaration
# ---------------------------------------------------------------------------

def _attn_defs(cfg, ll=()) -> dict:
    d, H, KH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    Lax = tuple("layers" for _ in ll)
    if cfg.mla is not None:
        m = cfg.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        return {
            "wq": ParamDef(ll + (d, H * qk), Lax + ("embed", "heads")),
            "wdkv": ParamDef(ll + (d, m.kv_lora_rank + m.qk_rope_head_dim),
                             Lax + ("embed", None)),
            "ckv_norm": ParamDef(ll + (m.kv_lora_rank,), Lax + (None,),
                                 init="ones"),
            "wuk": ParamDef(ll + (m.kv_lora_rank, H * m.qk_nope_head_dim),
                            Lax + (None, "heads")),
            "wuv": ParamDef(ll + (m.kv_lora_rank, H * m.v_head_dim),
                            Lax + (None, "heads")),
            "wo": ParamDef(ll + (H * m.v_head_dim, d),
                           Lax + ("heads", "embed")),
        }
    return {
        "wq": ParamDef(ll + (d, H * hd), Lax + ("embed", "heads")),
        "wk": ParamDef(ll + (d, KH * hd), Lax + ("embed", "kv_heads")),
        "wv": ParamDef(ll + (d, KH * hd), Lax + ("embed", "kv_heads")),
        "wo": ParamDef(ll + (H * hd, d), Lax + ("heads", "embed")),
    }


def _block_defs(cfg, ll=(), *, moe_layer: bool = False) -> dict:
    d = cfg.d_model
    Lax = tuple("layers" for _ in ll)
    out = {
        "ln1": ParamDef(ll + (d,), Lax + ("embed",), init="ones"),
        "ln2": ParamDef(ll + (d,), Lax + ("embed",), init="ones"),
        "attn": _attn_defs(cfg, ll),
    }
    if moe_layer:
        out["moe"] = moe_mod.moe_defs(cfg, ll)
    else:
        out["mlp"] = mlp_defs(cfg, cfg.d_ff, ll=ll)
    return out


def param_defs(cfg) -> dict:
    d = cfg.d_model
    V = padded_vocab(cfg.vocab_size)
    K = cfg.n_codebooks
    defs: Dict[str, Any] = {
        "embed": ParamDef((K, V, d), (None, "vocab", "embed")) if K
        else ParamDef((V, d), ("vocab", "embed")),
        "final_norm": ParamDef((d,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((d, K * V if K else V), ("embed", "vocab"))
    if cfg.family == "moe":
        fk = cfg.moe.first_k_dense
        if fk:
            defs["dense_layers"] = _block_defs(cfg, (fk,))
        defs["layers"] = _block_defs(cfg, (cfg.n_layers - fk,),
                                     moe_layer=True)
    elif cfg.family in _ATTN_ONLY:
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


# leaves the model reads in fp32 (rms_norm scales, MLA's latent norm; the
# Mamba2 A_log, D, dt_bias and gated-norm scale; the MoE router):
# casting them would change their values
_FP32_LEAVES = ("ln1", "ln2", "final_norm", "ckv_norm", "A_log", "D",
                "dt_bias", "norm", "router")


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
    """tokens (B, S) -> (B, S, D); audio (B, S, K) -> the sum over the K
    codebooks of their embeddings, added left to right in ``dtype`` as the
    JAX package adds them (a bf16 sum rounds after each add). Rows are
    gathered first, then cast: the same values as casting the whole
    table."""
    emb = params["embed"]
    if cfg.n_codebooks:
        x = emb[0][tokens[..., 0].long()].to(dtype)
        for k in range(1, cfg.n_codebooks):
            x = x + emb[k][tokens[..., k].long()].to(dtype)
        return x
    return emb[tokens.long()].to(dtype)


def lm_head(cfg, params, x, dtype):
    """(B, S, D) -> logits (B, S, V_padded); audio (B, S, K, V_padded)."""
    w = params["embed"].to(dtype).t() if cfg.tie_embeddings \
        else params["head"].to(dtype)
    logits = x @ w
    if cfg.n_codebooks:
        B, S = x.shape[:2]
        return logits.reshape(B, S, cfg.n_codebooks,
                              padded_vocab(cfg.vocab_size))
    return logits


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


def _transformer_block(cfg, p, x, cos, sin, dtype, *, moe_layer=False,
                       collect_cache: bool = False):
    """Returns (x, aux, cache): aux the MoE layer's load-balance loss (0.0
    elsewhere); cache (k, v), or MLA's (ckv, k_rope), with
    ``collect_cache``."""
    B, S, D = x.shape
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.mla is not None:
        y, cache = attn.mla_prefill(p["attn"], h, cos, sin, cfg, dtype)
    else:
        pa = p["attn"]
        q = (h @ pa["wq"].to(dtype)).reshape(B, S, H, hd)
        k = (h @ pa["wk"].to(dtype)).reshape(B, S, KH, hd)
        v = (h @ pa["wv"].to(dtype)).reshape(B, S, KH, hd)
        if cos is not None:                # audio: absolute positions
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
        cache = (k, v)
        o = attn.flash_attention(q, k, v, causal=True,
                                 window=cfg.swa_window,
                                 q_chunk=cfg.attn_q_chunk,
                                 scale=1.0 / math.sqrt(hd),
                                 schedule=cfg.attn_schedule)
        y = o.reshape(B, S, H * hd) @ pa["wo"].to(dtype)
    x = x + y
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    if moe_layer:
        f, aux = moe_mod.moe_ffn(cfg, p["moe"], h2, dtype)
    else:
        f, aux = mlp_apply(cfg, p["mlp"], h2, dtype), 0.0
    return x + f, aux, (cache if collect_cache else None)


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


def _stacks(cfg, params):
    """The stacked layer trees in order, each with whether its layers are
    MoE layers: deepseek-v2-lite's ``dense_layers``, then ``layers``."""
    out = [(params["dense_layers"], False)] if "dense_layers" in params \
        else []
    return out + [(params["layers"], cfg.family == "moe")]


def forward(cfg, params, batch, *, collect_cache: bool = False):
    """batch: dict with 'tokens' (B, S) (audio: (B, S, K)) or 'embeds'
    (B, S, D), and for vlm optionally 'pos3' (3, B, S) (default: three
    equal streams 0..S-1).

    Returns (logits (B, S, V_padded), aux_loss, caches_or_None); audio
    logits are (B, S, K, V_padded); aux_loss is the sum over the MoE
    layers of their load-balance loss (0.0 without MoE). With
    ``collect_cache`` the caches hold "kv": (k, v), each (G, B, S, KH, hd)
    for the G attention applications (MLA: (ckv (G, B, S, lora), k_rope
    (G, B, S, rope)) of the MoE layers, and "kv_dense" those of the dense
    layers before them). The ssm and hybrid families always
    return their per-layer "ssm" (L, B, nh, hp, ns) and "conv_x/b/c"
    (L, B, d_conv-1, C) states (``repro/models/lm.py:381-382``)."""
    dtype = cfg.compute_dt()
    if "embeds" in batch:
        x = batch["embeds"].to(dtype)
    else:
        x = embed_tokens(cfg, params, batch["tokens"], dtype)
    B, S = x.shape[:2]
    dev = x.device
    fam = cfg.family
    cos = sin = None
    if fam == "audio":
        pos_tab = torch.from_numpy(sinusoidal_positions(S, cfg.d_model))
        x = x + pos_tab.to(dev, dtype)[None]
    elif fam == "vlm":
        pos3 = batch.get("pos3")
        if pos3 is None:
            pos3 = torch.arange(S, device=dev)[None, None].expand(3, B, S)
        cos, sin = mrope_cos_sin(pos3, cfg.hd, cfg.rope_theta,
                                 cfg.mrope_sections)
    elif fam != "ssm":
        rope_dim = cfg.mla.qk_rope_head_dim if cfg.mla is not None \
            else cfg.hd
        cos, sin = rope_cos_sin(torch.arange(S, device=dev), rope_dim,
                                cfg.rope_theta)
    cast = dtype if cfg.bf16_stacked_params else None
    run = _maybe_remat(cfg)
    kvs = {"kv_dense": [], "kv": []}     # per layer: (k, v) or (ckv, kr)
    states, convs, auxs = [], [], []

    def attn_body(p, x, moe_layer):
        return _transformer_block(cfg, p, x, cos, sin, dtype,
                                  moe_layer=moe_layer,
                                  collect_cache=collect_cache)

    def attend(p, x, moe_layer=False, key="kv"):
        x, aux, kv = run(attn_body, p, x, moe_layer)
        if moe_layer:
            auxs.append(aux)
        if collect_cache:
            kvs[key].append(kv)
        return x

    def mamba_body(p_l, x):
        y, st, conv = mam.mamba_block(cfg, p_l, x, dtype, return_state=True)
        return x + y, st, conv

    if fam in _ATTN_ONLY:
        for stack, moe_layer in _stacks(cfg, params):
            key = "kv" if stack is params["layers"] else "kv_dense"
            for p_l in _layers(stack, cast):
                x = attend(p_l, x, moe_layer, key)
    else:
        for i, p_l in enumerate(_layers(params["layers"], cast)):
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
    for key, per_layer in kvs.items():
        if per_layer:
            caches[key] = tuple(torch.stack(t) for t in zip(*per_layer))
    aux = torch.stack(auxs).sum() if auxs else 0.0
    return logits, aux, (caches if collect_cache or states else None)


def prefill_cache(cfg, caches, S: int) -> dict:
    """Reformat forward(collect_cache=True) output into the decode cache
    layout (same keys/shapes as cache_spec_defs). SWA archs keep the last
    ``window`` positions, which land in the ring order decode writes
    (position p at slot p % window) only when S <= window or window | S.
    Any other S raises ``ValueError``: the JAX package keeps them in
    prompt order there, and its decode then attends to the wrong keys
    (its logits miss the full forward's by up to 4.87 on a smoke model);
    the port refuses, as its ``decode_step`` refuses a position outside
    the cache where JAX clamps."""
    win = cfg.swa_window
    if win and S > win and S % win:
        raise ValueError(f"a prompt of {S} tokens does not fill the "
                         f"{win}-slot ring cache in ring order (it needs "
                         f"S <= {win} or a multiple of {win})")

    def ring(t):                       # t: (L,B,S,KH,hd)
        if win and t.shape[2] > win:
            t = t[:, :, -win:]
        # contiguous: decode views each layer's cache as a page pool
        return t.to(torch.bfloat16).contiguous()

    out = {}
    if cfg.family in ("ssm", "hybrid"):
        out["ssm"] = caches["ssm"].float()
        for n in _CONV:
            out[n] = caches[n].to(torch.bfloat16)
    if cfg.mla is not None:                # compressed latent cache
        parts = [caches[n] for n in ("kv_dense", "kv") if n in caches]
        out["ckv"] = torch.cat([c for c, _ in parts]).to(torch.bfloat16)
        out["kr"] = torch.cat([r for _, r in parts]).to(torch.bfloat16)
    elif cfg.family != "ssm":
        k, v = caches["kv"]
        out["k"], out["v"] = ring(k), ring(v)
    return out


# ---------------------------------------------------------------------------
# Decode (serve_step): one token against the KV cache / SSM state
# ---------------------------------------------------------------------------

def cache_spec_defs(cfg, max_len: int, batch: int) -> dict:
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
    if cfg.mla is not None:                # MLA: compressed latent cache
        m = cfg.mla
        ax = ("layers", "batch", "kv_seq", None)
        defs["ckv"] = ParamDef((L, batch, S, m.kv_lora_rank), ax,
                               dtype="bfloat16")
        defs["kr"] = ParamDef((L, batch, S, m.qk_rope_head_dim), ax,
                              dtype="bfloat16")
    elif fam != "ssm":
        G = L // cfg.attn_every if fam == "hybrid" else L
        ax = ("layers", "batch", "kv_seq", "kv_heads", None)
        defs["k"] = ParamDef((G, batch, S, KH, hd), ax, dtype="bfloat16")
        defs["v"] = ParamDef((G, batch, S, KH, hd), ax, dtype="bfloat16")
    return defs


def whole_pages(S: int) -> int:
    """Positions a sequence of a k/v cache of logical length ``S`` takes in
    whole decode pages: ceil(S / PAGE_SIZE) * PAGE_SIZE."""
    return -(-S // PAGE_SIZE) * PAGE_SIZE


def init_cache(cfg, max_len, batch, *, device="cuda") -> dict:
    """Zero cache (bf16 k/v, MLA ckv/kr and conv states, fp32 ssm state)
    with the shapes of ``cache_spec_defs``, JAX's, for any length. A k/v
    cache of logical length S is allocated in whole decode pages
    (``whole_pages(S)`` positions a sequence) and returned as its length-S
    view, which decode reads in place as a page pool (``page_pool``)."""
    dev = resolve_device(device)
    out = {}
    for n, pd in cache_spec_defs(cfg, max_len, batch).items():
        dt = getattr(torch, pd.dtype)
        if n in ("k", "v"):
            G, B, S, KH, hd = pd.shape
            out[n] = torch.zeros((G, B, whole_pages(S), KH, hd), dtype=dt,
                                 device=dev)[:, :, :S]
        else:
            out[n] = torch.zeros(pd.shape, dtype=dt, device=dev)
    return out


def grow_cache(cfg, cache, max_len) -> dict:
    """The prefill cache (``prefill_cache``, sized to the prompt) in a zero
    cache of ``max_len`` positions on the same device, for decode: k/v
    (copied into ``init_cache``'s whole pages) and MLA's ckv/kr grow along
    the sequence; the SSM and conv states carry as they are."""
    some = next(iter(cache.values()))
    full = init_cache(cfg, max_len, some.shape[1], device=some.device)
    for n, t in cache.items():
        if t.shape == full[n].shape and n not in ("k", "v"):
            full[n] = t
        else:
            full[n][tuple(slice(0, s) for s in t.shape)] = t
    return full


def identity_pages(B, Smax, pos, window, device):
    """Page table and lengths that make the paged op read a dense cache of
    logical length Smax laid out in whole pages (``page_pool``): row b is
    pages b·ceil(Smax/P) + j for the pages holding positions <= pos (ring
    order for a window cache), lengths = pos + 1 (<= Smax)."""
    per_seq = whole_pages(Smax) // PAGE_SIZE
    length = min(pos + 1, Smax) if window else pos + 1
    nblk = -(-length // PAGE_SIZE)
    table = (torch.arange(B, device=device, dtype=torch.int32)[:, None]
             * per_seq
             + torch.arange(nblk, device=device, dtype=torch.int32)[None])
    lengths = torch.full((B,), length, dtype=torch.int32, device=device)
    return table, lengths


def page_pool(c, dtype):
    """One layer of a k/v cache, (B, S, KH, hd), in ``dtype`` as the page
    pool (B·Sp/P, P, KH, hd) the paged op reads, Sp = ``whole_pages(S)``:
    the cache itself where it lies in whole pages (``init_cache``'s
    layout, or S a multiple of P), else a zero-padded copy."""
    B, S, KH, hd = c.shape
    Sp = whole_pages(S)
    c = c.to(dtype)
    row = KH * hd
    fits = (c.storage_offset() + B * Sp * row) * c.element_size() \
        <= c.untyped_storage().nbytes()
    if c.stride() == (Sp * row, row, hd, 1) and fits:
        return c.as_strided((B * Sp // PAGE_SIZE, PAGE_SIZE, KH, hd),
                            (PAGE_SIZE * row, row, hd, 1))
    pad = c.new_zeros((B, Sp, KH, hd))
    pad[:, :S] = c
    return pad.view(B * Sp // PAGE_SIZE, PAGE_SIZE, KH, hd)


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
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    idx = pos % Smax if cfg.swa_window else pos     # the logical length
    kc[:, idx] = k[:, 0].to(kc.dtype)
    vc[:, idx] = v[:, 0].to(vc.dtype)
    # JAX (lm.py:507): decode_attention(q, kc.astype(dtype), ...). Here the
    # same cache, cast to the compute dtype (a no-op for bf16), is viewed
    # as a page pool and read by the paged op through an identity table.
    pool_k, pool_v = page_pool(kc, dtype), page_pool(vc, dtype)
    table, lengths = pages
    o = _paged_ops.paged_attention(q[:, 0], pool_k, pool_v, table, lengths,
                                   scale=1.0 / math.sqrt(hd))
    y = o.reshape(B, H * hd) @ pa["wo"].to(dtype)
    return x + y[:, None]


def _decode_ffn(cfg, p, x, dtype, moe_layer=False):
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    if moe_layer:
        # route the whole token batch jointly (B plays the sequence role)
        f, _ = moe_mod.moe_ffn(cfg, p["moe"], h2[:, 0][None], dtype)
        return x + f[0][:, None]
    return x + mlp_apply(cfg, p["mlp"], h2, dtype)


def decode_step(cfg, params, cache, tokens, pos: int):
    """One decode step. tokens: (B,1) int (audio: (B,1,K)); pos: the new
    token's position. Writes the token's K/V (MLA: its ckv and k_rope) and
    each layer's new SSM and conv state into ``cache`` in place and returns
    (logits (B, V_padded) (audio: (B, K, V_padded)), cache)."""
    dtype = cfg.compute_dt()
    pos = int(pos)
    B = tokens.shape[0]
    x = embed_tokens(cfg, params, tokens, dtype)           # (B,1,D)
    dev = x.device
    fam = cfg.family
    cos = sin = None
    if fam == "audio":
        # the absolute sinusoidal row at ``pos``, computed in fp32 here as
        # the JAX package computes it (its prefill reads the float64 numpy
        # table instead)
        ang = torch.tensor(float(pos), dtype=torch.float32, device=dev)
        dim = torch.arange(0, cfg.d_model, 2, device=dev) / cfg.d_model
        base = ang / torch.pow(10_000.0, dim)
        pe = torch.zeros(cfg.d_model, dtype=torch.float32, device=dev)
        pe[0::2] = torch.sin(base)
        pe[1::2] = torch.cos(base)
        x = x + pe.to(dtype)[None, None]
    elif fam == "vlm":
        # all three M-RoPE streams at ``pos`` (the JAX package's decode)
        p3 = torch.full((3, B, 1), pos, device=dev)
        cos, sin = mrope_cos_sin(p3, cfg.hd, cfg.rope_theta,
                                 cfg.mrope_sections)
    elif fam != "ssm":
        rope_dim = cfg.mla.qk_rope_head_dim if cfg.mla is not None \
            else cfg.hd
        cos, sin = rope_cos_sin(torch.tensor([pos], device=dev), rope_dim,
                                cfg.rope_theta)
    if fam != "ssm":
        Smax = cache["ckv" if cfg.mla is not None else "k"].shape[2]
        if not cfg.swa_window and not 0 <= pos < Smax:
            raise ValueError(f"position {pos} is outside the cache ({Smax})")
        if cfg.mla is None:
            pages = identity_pages(B, Smax, pos, cfg.swa_window, dev)

    def attend(p, x, g, moe_layer=False):
        if cfg.mla is not None:
            h = rms_norm(x, p["ln1"], cfg.norm_eps)
            y, _, _ = attn.mla_decode(p["attn"], h, cache["ckv"][g],
                                      cache["kr"][g], pos, cos, sin, cfg,
                                      dtype)
            x = x + y
        else:
            x = _decode_attn_block(cfg, p, x, cache["k"][g], cache["v"][g],
                                   pos, cos, sin, dtype, pages)
        return _decode_ffn(cfg, p, x, dtype, moe_layer)

    if fam in _ATTN_ONLY:
        g = 0                              # the layer's index in the cache
        for stack, moe_layer in _stacks(cfg, params):
            for p_l in _layers(stack):
                x = attend(p_l, x, g, moe_layer)
                g += 1
    else:
        # JAX replaces each conv state by the step's output, whose dtype is
        # that of concatenating the cached (bf16) state with the compute
        # dtype: fp32 compute turns the conv states fp32 from the first step
        for n in _CONV:
            want = torch.promote_types(cache[n].dtype, dtype)
            if cache[n].dtype != want:
                cache[n] = cache[n].to(want)
        for i, p_l in enumerate(_layers(params["layers"])):
            y, st, conv = mam.mamba_decode_block(
                cfg, p_l, x, cache["ssm"][i],
                tuple(cache[n][i] for n in _CONV), dtype)
            x = x + y
            cache["ssm"][i] = st
            for n, t in zip(_CONV, conv):
                cache[n][i] = t
            if fam == "hybrid" and (i + 1) % cfg.attn_every == 0:
                x = attend(params["shared_attn"], x, i // cfg.attn_every)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_head(cfg, params, x, dtype)                # (B,1,V[,K])
    return logits[:, 0], cache
