"""Model assembly for every family: dense / vlm / audio / moe / ssm /
hybrid (the port's counterpart of ``repro.models.lm``, its ``mesh=None``
path and its mesh path).

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

The mesh path (``forward(mesh=, rules=)``, JAX's): parameters are
DTensors placed by ``param_specs`` (``place_params``), the batch is placed
by ``input_defs``' logical axes, and every sharding constraint of the JAX
package is a ``partitioning.constrain`` at the same place (the residual
stream at each layer's entry, ``sp_norm``'s two, attention's heads-sharded
blocks, Mamba2's heads, the MoE dispatch's six). Kernels see local shards
only (``partitioning.local_map``). ``decode_step(mesh=, rules=)`` is
JAX's decode as GSPMD partitions it: the cache split on ``kv_seq``, each
rank attending over its shard of the sequence and the shards merged by
their log-sum-exps.
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
from repro_torch.models import partitioning as part
from repro_torch.models.layers import (ParamDef, abstract, apply_rope,
                                       materialize, mlp_apply, mlp_defs,
                                       mrope_cos_sin, padded_vocab, rms_norm,
                                       rope_cos_sin, sinusoidal_positions,
                                       specs, tree_map_defs)
from repro_torch.tree import tree_map

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


def abstract_params(cfg) -> dict:
    """The parameter tree as ``meta`` tensors (no storage)."""
    return abstract(_apply_param_dtype(cfg, param_defs(cfg)))


def param_specs(cfg, mesh, rules=None) -> dict:
    return specs(param_defs(cfg), mesh, rules)


def param_shardings(cfg, mesh, rules=None) -> dict:
    """Each parameter's ``NamedSharding`` on ``mesh`` (by ``param_specs``)."""
    return tree_map_defs(lambda pd: part.sharding_for(pd.logical, mesh, rules),
                         param_defs(cfg))


def place_params(cfg, params, mesh, rules=None) -> dict:
    """``params`` (full tensors, the same on every rank) as DTensors placed
    by ``param_specs``."""
    return tree_map(part.place, params, param_shardings(cfg, mesh, rules))


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

def embed_tokens(cfg, params, tokens, dtype, mesh=None, rules=None):
    """tokens (B, S) -> (B, S, D); audio (B, S, K) -> the sum over the K
    codebooks of their embeddings, added left to right in ``dtype`` as the
    JAX package adds them (a bf16 sum rounds after each add). Rows are
    gathered first, then cast: the same values as casting the whole
    table. On a mesh each rank gathers its sequences' rows from the whole
    table (``local_map``): the same gather, and the same gradient, as
    without one (DTensor 2.11 has no sharding rule for the gradient of a
    gather by index)."""
    if mesh is None:
        return _gather_rows(cfg, params["embed"], tokens, dtype)

    def pl(*logical):
        return part.placements_for(part.spec_for(logical, mesh, rules), mesh)
    table = pl(*(None,) * params["embed"].ndim)
    return part.local_map(
        lambda emb, tok: _gather_rows(cfg, emb, tok, dtype), mesh,
        (table, pl("batch", *(None,) * (tokens.ndim - 1))),
        pl("batch", None, None))(params["embed"], tokens)


def _gather_rows(cfg, emb, tokens, dtype):
    if cfg.n_codebooks:
        x = emb[0][tokens[..., 0].long()].to(dtype)
        for k in range(1, cfg.n_codebooks):
            x = x + emb[k][tokens[..., k].long()].to(dtype)
        return x
    return emb[tokens.long()].to(dtype)


def lm_head(cfg, params, x, dtype, mesh=None, rules=None):
    """(B, S, D) -> logits (B, S, V_padded); audio (B, S, K, V_padded). On
    a mesh an audio head's (K·V) logits are gathered before they are cut
    into K codebooks: DTensor cannot view a dim split 16 ways as (K, V)
    when 16 does not divide K."""
    w = params["embed"].to(dtype).t() if cfg.tie_embeddings \
        else params["head"].to(dtype)
    logits = x @ w
    if cfg.n_codebooks:
        B, S = x.shape[:2]
        if mesh is not None:
            logits = part.constrain(logits, mesh, "batch", None, None,
                                    rules=rules)
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


def residual(t, mesh, rules):
    """The residual stream's layout (JAX's constraint at each layer's
    entry): sequence-sharded on a mesh; ``t`` itself without one. A
    block's output is put in it before it is added, so that the gradient
    reaching the block's last projection is laid out as that projection's
    output, not sequence-split (which DTensor 2.11 cannot view as
    (B·S, D))."""
    return part.constrain(t, mesh, "batch", "act_seq", None, rules=rules)


def whole_seq(h, mesh, rules, sp_norm=False):
    """Normed activations (B, S, D) as the projections read them on a
    mesh: whole sequences. With ``sp_norm`` (Megatron-SP) they are first
    constrained sequence-sharded (JAX's two constraints). DTensor (torch
    2.11) refuses the (B·S, D) view of a matmul whose S is split, so the
    port gathers before every projection, not only under ``sp_norm``."""
    if sp_norm:
        h = part.constrain(h, mesh, "batch", "act_seq", None, rules=rules)
    return part.constrain(h, mesh, "batch", None, None, rules=rules)


def _heads_whole(t, n_heads, tp, axis, mesh, rules):
    """A (B, S, heads·hd) DTensor constrained to ``axis`` on its last dim
    when the model axis divides its heads, else replicated there."""
    ax = axis if n_heads % tp == 0 else None
    return part.constrain(t, mesh, "batch", None, ax, rules=rules)


def _on_shards(fn, t, mesh):
    """``fn`` of ``t``; on a mesh, of each rank's shard (``local_map``, the
    placements kept), for an ``fn`` that acts on dims no mesh dim splits:
    DTensor 2.11 (the card's) fails to redistribute around the pad of
    padded heads and its slice."""
    if mesh is None:
        return fn(t)
    return part.local_map(fn, mesh, (t.placements,), t.placements)(t)


def _transformer_block(cfg, p, x, cos, sin, dtype, *, moe_layer=False,
                       collect_cache: bool = False, mesh=None, rules=None):
    """Returns (x, aux, cache): aux the MoE layer's load-balance loss (0.0
    elsewhere); cache (k, v), or MLA's (ckv, k_rope), with
    ``collect_cache``."""
    B, S, D = x.shape
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if mesh is not None:
        h = whole_seq(h, mesh, rules, cfg.sp_norm)
    if cfg.mla is not None:
        y, cache = attn.mla_prefill(p["attn"], h, cos, sin, cfg, dtype,
                                    mesh=mesh, rules=rules)
    else:
        pa = p["attn"]
        tp = part.axis_sizes(mesh).get("model", 1) if mesh is not None \
            else 1
        q, k, v = (h @ pa[w].to(dtype) for w in ("wq", "wk", "wv"))
        if mesh is not None:
            # DTensor splits a (B, S, heads·hd) projection into (heads, hd)
            # only with whole heads in each shard
            q = _heads_whole(q, H, tp, "heads", mesh, rules)
            k = _heads_whole(k, KH, tp, "kv_heads", mesh, rules)
            v = _heads_whole(v, KH, tp, "kv_heads", mesh, rules)
        q = q.reshape(B, S, H, hd)
        k = k.reshape(B, S, KH, hd)
        v = v.reshape(B, S, KH, hd)
        if cos is not None:                # audio: absolute positions
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
        cache = (k, v)
        # heads that don't divide the model axis (yi: 56, qwen2-vl: 12)
        # are zero-padded AFTER the GQA group expansion so the q→kv-group
        # mapping stays correct; padded heads are sliced off again
        Hp = -(-H // tp) * tp
        if Hp != H:
            k = k.repeat_interleave(H // KH, dim=2)
            v = v.repeat_interleave(H // KH, dim=2)
            pad = (0, 0, 0, Hp - H)
            q, k, v = (_on_shards(
                lambda t: torch.nn.functional.pad(t, pad), t, mesh)
                for t in (q, k, v))
        o = attn.flash_attention(q, k, v, causal=True,
                                 window=cfg.swa_window,
                                 q_chunk=cfg.attn_q_chunk,
                                 scale=1.0 / math.sqrt(hd),
                                 schedule=cfg.attn_schedule,
                                 mesh=mesh, rules=rules)
        if Hp != H:
            if mesh is not None:       # the padded heads whole first
                o = part.constrain(o, mesh, "batch", None, None, None,
                                   rules=rules)
            o = _on_shards(lambda t: t[:, :, :H, :], o, mesh)
        o = o.reshape(B, S, H * hd)
        if mesh is not None:       # and so must its gradient, back
            o = _heads_whole(o, H, tp, "heads", mesh, rules)
        y = o @ pa["wo"].to(dtype)
    x = x + residual(y, mesh, rules)
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    if mesh is not None:
        h2 = whole_seq(h2, mesh, rules, cfg.sp_norm and not moe_layer)
    if moe_layer:
        f, aux = moe_mod.moe_ffn(cfg, p["moe"], h2, dtype, mesh=mesh,
                                 rules=rules)
    else:
        f, aux = mlp_apply(cfg, p["mlp"], h2, dtype), 0.0
    return x + residual(f, mesh, rules), aux, \
        (cache if collect_cache else None)


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


def place_batch(cfg, batch, mesh, rules=None) -> dict:
    """A batch's plain tensors (the same on every rank) as DTensors placed
    by their logical axes (``input_defs``: the batch axis sharded; "pos3"
    on its axis 1); its DTensors as they are."""
    def placed(name, t):
        if isinstance(t, part.DTensor):
            return t
        logical = (None, "batch") if name == "pos3" else ("batch",)
        logical += (None,) * (t.ndim - len(logical))
        return part.place(t, part.sharding_for(logical, mesh, rules))
    return {k: placed(k, v) for k, v in batch.items()}


def forward(cfg, params, batch, *, mesh=None, rules=None,
            collect_cache: bool = False):
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
    (L, B, d_conv-1, C) states (``repro/models/lm.py:381-382``).

    On a mesh (``mesh``/``rules``, the JAX package's): ``params`` are
    DTensors (``place_params``), plain batch tensors are placed
    (``place_batch``), and the outputs are DTensors."""
    if mesh is not None:
        batch = place_batch(cfg, batch, mesh, rules)
    dtype = cfg.compute_dt()
    if "embeds" in batch:
        x = batch["embeds"].to(dtype)
    else:
        x = embed_tokens(cfg, params, batch["tokens"], dtype, mesh, rules)
    B, S = x.shape[:2]
    dev = x.device
    fam = cfg.family
    # position tables are made whole on every rank: on a mesh they enter
    # as replicated DTensors
    rep = (lambda t: t) if mesh is None else \
        (lambda t: part.replicate(t, mesh))
    cos = sin = None
    if fam == "audio":
        pos_tab = torch.from_numpy(sinusoidal_positions(S, cfg.d_model))
        x = x + rep(pos_tab.to(dev, dtype)[None])
    elif fam == "vlm":
        pos3 = batch.get("pos3")
        if pos3 is None:
            pos3 = torch.arange(S, device=dev)[None, None].expand(3, B, S)
        cos, sin = map(rep, mrope_cos_sin(part.full(pos3), cfg.hd,
                                          cfg.rope_theta,
                                          cfg.mrope_sections))
    elif fam != "ssm":
        rope_dim = cfg.mla.qk_rope_head_dim if cfg.mla is not None \
            else cfg.hd
        cos, sin = map(rep, rope_cos_sin(torch.arange(S, device=dev),
                                         rope_dim, cfg.rope_theta))
    cast = dtype if cfg.bf16_stacked_params else None
    run = _maybe_remat(cfg)
    kvs = {"kv_dense": [], "kv": []}     # per layer: (k, v) or (ckv, kr)
    states, convs, auxs = [], [], []

    def cstr(t):
        return residual(t, mesh, rules)

    def attn_body(p, x, moe_layer):
        return _transformer_block(cfg, p, cstr(x), cos, sin, dtype,
                                  moe_layer=moe_layer,
                                  collect_cache=collect_cache, mesh=mesh,
                                  rules=rules)

    def attend(p, x, moe_layer=False, key="kv"):
        x, aux, kv = run(attn_body, p, x, moe_layer)
        if moe_layer:
            auxs.append(aux)
        if collect_cache:
            kvs[key].append(kv)
        return x

    def mamba_body(p_l, x):
        y, st, conv = mam.mamba_block(cfg, p_l, cstr(x), dtype,
                                      return_state=True, mesh=mesh,
                                      rules=rules)
        return x + cstr(y), st, conv

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
    x = cstr(rms_norm(x, params["final_norm"], cfg.norm_eps))
    if mesh is not None:
        x = whole_seq(x, mesh, rules)
    logits = lm_head(cfg, params, x, dtype, mesh, rules)
    caches: Dict[str, Any] = {}
    if states:
        caches["ssm"] = torch.stack(states)
        for n, per_layer in zip(_CONV, zip(*convs)):
            caches[n] = torch.stack(per_layer)
    for key, per_layer in kvs.items():
        if per_layer:
            caches[key] = tuple(torch.stack(t) for t in zip(*per_layer))
    aux = torch.stack(auxs).sum() if auxs else 0.0
    if mesh is not None:         # whole values, safe to cast (prefill_cache)
        logits = part.settle(logits)
        caches = tree_map(part.settle, caches)
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


def abstract_cache(cfg, max_len, batch) -> dict:
    """The cache tree as ``meta`` tensors (``cache_spec_defs``' shapes)."""
    return abstract(cache_spec_defs(cfg, max_len, batch))


def cache_specs(cfg, max_len, batch, mesh, rules=None) -> dict:
    return specs(cache_spec_defs(cfg, max_len, batch), mesh, rules)


def input_defs(cfg, shape) -> dict:
    """name -> (shape, dtype, logical axes) of the model inputs of an
    (arch × shape) cell, as the JAX package's: VLM inputs are
    precomputed patch embeddings, audio inputs EnCodec token ids."""
    B, S = shape.global_batch, shape.seq_len
    K = cfg.n_codebooks
    tok = ((B, S, K), "int32", ("batch", None, None)) if K else \
        ((B, S), "int32", ("batch", None))
    out = {}
    if shape.kind in ("train", "prefill"):
        if cfg.family == "vlm":
            out["embeds"] = ((B, S, cfg.d_model), "bfloat16",
                             ("batch", None, None))
            out["pos3"] = ((3, B, S), "int32", (None, "batch", None))
        else:
            out["tokens"] = tok
        if shape.kind == "train":
            out["labels"] = tok
    else:  # decode: one new token against a seq_len cache
        out["tokens"] = ((B, 1, K), "int32", ("batch", None, None)) if K \
            else ((B, 1), "int32", ("batch", None))
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


def identity_pages(B, Smax, pos, window, device, length=None):
    """Page table and lengths that make the paged op read a dense cache of
    logical length Smax laid out in whole pages (``page_pool``): row b is
    pages b·ceil(Smax/P) + j for the pages holding positions <= pos (ring
    order for a window cache), lengths = pos + 1 (<= Smax); or, given
    ``length`` (a shard's, which may be 0), its pages (at least one)."""
    per_seq = whole_pages(Smax) // PAGE_SIZE
    if length is None:
        length = min(pos + 1, Smax) if window else pos + 1
    nblk = max(1, -(-length // PAGE_SIZE))
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


def _decode_attn_mesh(cfg, p, x, kc, vc, pos, cos, sin, dtype, mesh, rules):
    """``_decode_attn_block`` on a mesh: kc/vc (B, S, KH, hd) DTensor views
    of one layer of the cache, split on ``kv_seq`` (and ``batch``). q, k
    and v are gathered over their heads (small); the rank holding the
    token's slot writes its K/V at its local index; each rank runs the
    paged op with lse over its shard of the sequence (a length of
    clamp(length − r·S_local, 0, S_local), in ``local_map``), for all
    query heads, and the ranks merge their (o, lse) in fp32
    (``attention.merge_over``)."""
    B = x.shape[0]
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    Smax = kc.shape[1]
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    pa = p["attn"]

    def proj(w, n):
        t = part.constrain(h @ pa[w].to(dtype), mesh, "batch", None, None,
                           rules=rules)
        return t.reshape(B, 1, n, hd)
    q, k, v = proj("wq", H), proj("wk", KH), proj("wv", KH)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    idx = pos % Smax if cfg.swa_window else pos
    length = min(pos + 1, Smax) if cfg.swa_window else pos + 1
    cpl = kc.placements
    r, s_loc, groups = attn.seq_shard(mesh, cpl, 1, Smax)
    tpl = part.placements_for(part.spec_for(("batch", None, None), mesh,
                                            rules), mesh)
    scale = 1.0 / math.sqrt(hd)
    n_loc = min(max(length - r * s_loc, 0), s_loc)

    def local(ql, kn, vn, kl, vl):
        lo = r * s_loc
        if lo <= idx < lo + s_loc:
            kl[:, idx - lo] = kn.to(kl.dtype)
            vl[:, idx - lo] = vn.to(vl.dtype)
        table, lengths = identity_pages(ql.shape[0], s_loc, 0, 0, ql.device,
                                        length=n_loc)
        o, lse = _paged_ops.paged_attention(
            ql, page_pool(kl, dtype), page_pool(vl, dtype), table, lengths,
            scale=scale, with_lse=True)
        return attn.merge_over(o, lse, groups)
    o = part.local_map(local, mesh, (tpl, tpl, tpl, cpl, cpl), tpl)(
        q[:, 0], k[:, 0], v[:, 0], kc, vc)
    y = o.reshape(B, H * hd) @ pa["wo"].to(dtype)
    return x + y[:, None]


def _decode_ffn(cfg, p, x, dtype, moe_layer=False, mesh=None, rules=None):
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    if moe_layer:
        # route the whole token batch jointly (B plays the sequence role):
        # one group, so on a mesh its (1, B) batch and sequence stay whole
        r = None if mesh is None else \
            dict(rules or part.DEFAULT_RULES, batch=(), act_seq=())
        f, _ = moe_mod.moe_ffn(cfg, p["moe"], h2[:, 0][None], dtype,
                               mesh=mesh, rules=r)
        return x + f[0][:, None]
    return x + mlp_apply(cfg, p["mlp"], h2, dtype)


def decode_step(cfg, params, cache, tokens, pos: int, *, mesh=None,
                rules=None):
    """One decode step. tokens: (B,1) int (audio: (B,1,K)); pos: the new
    token's position. Writes the token's K/V (MLA: its ckv and k_rope) and
    each layer's new SSM and conv state into ``cache`` in place and returns
    (logits (B, V_padded) (audio: (B, K, V_padded)), cache).

    On a mesh (``mesh``, ``rules``; JAX's decode partitioned by GSPMD)
    ``params`` are DTensors (``place_params``), the cache is DTensors
    placed by ``cache_specs`` (k/v, ckv and kr split on ``kv_seq``, the
    SSM state on ``ssm_heads``, all on ``batch``), plain tokens are placed
    by their logical axes, and the logits are a DTensor: attention runs
    on each rank's shard of the sequence and merges the shards
    (``_decode_attn_mesh``), MLA on DTensors, each Mamba2 layer on the
    rank's SSM heads, MoE as one group."""
    dtype = cfg.compute_dt()
    pos = int(pos)
    B = tokens.shape[0]
    if mesh is not None:
        tokens = place_batch(cfg, {"tokens": tokens}, mesh, rules)["tokens"]
    x = embed_tokens(cfg, params, tokens, dtype, mesh, rules)   # (B,1,D)
    dev = x.device
    fam = cfg.family
    rep = (lambda t: t) if mesh is None else \
        (lambda t: part.replicate(t, mesh))
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
        x = x + rep(pe.to(dtype)[None, None])
    elif fam == "vlm":
        # all three M-RoPE streams at ``pos`` (the JAX package's decode)
        p3 = torch.full((3, B, 1), pos, device=dev)
        cos, sin = map(rep, mrope_cos_sin(p3, cfg.hd, cfg.rope_theta,
                                          cfg.mrope_sections))
    elif fam != "ssm":
        rope_dim = cfg.mla.qk_rope_head_dim if cfg.mla is not None \
            else cfg.hd
        cos, sin = map(rep, rope_cos_sin(torch.tensor([pos], device=dev),
                                         rope_dim, cfg.rope_theta))
    if fam != "ssm":
        Smax = cache["ckv" if cfg.mla is not None else "k"].shape[2]
        if not cfg.swa_window and not 0 <= pos < Smax:
            raise ValueError(f"position {pos} is outside the cache ({Smax})")
        if cfg.mla is None and mesh is None:
            pages = identity_pages(B, Smax, pos, cfg.swa_window, dev)

    def attend(p, x, g, moe_layer=False):
        if cfg.mla is not None:
            h = rms_norm(x, p["ln1"], cfg.norm_eps)
            y, _, _ = attn.mla_decode(p["attn"], h, cache["ckv"][g],
                                      cache["kr"][g], pos, cos, sin, cfg,
                                      dtype, mesh=mesh, rules=rules)
            x = x + y
        elif mesh is not None:
            x = _decode_attn_mesh(cfg, p, x, cache["k"][g], cache["v"][g],
                                  pos, cos, sin, dtype, mesh, rules)
        else:
            x = _decode_attn_block(cfg, p, x, cache["k"][g], cache["v"][g],
                                   pos, cos, sin, dtype, pages)
        return _decode_ffn(cfg, p, x, dtype, moe_layer, mesh, rules)

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
                tuple(cache[n][i] for n in _CONV), dtype, mesh=mesh,
                rules=rules)
            x = x + y
            cache["ssm"][i] = st
            for n, t in zip(_CONV, conv):
                cache[n][i] = t
            if fam == "hybrid" and (i + 1) % cfg.attn_every == 0:
                x = attend(params["shared_attn"], x, i // cfg.attn_every)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_head(cfg, params, x, dtype, mesh, rules)                # (B,1,V[,K])
    if mesh is not None:
        logits = part.settle(logits)
    return logits[:, 0], cache
