"""train_step / serve_step / prefill_step factories, the LM loss and the
sharding assembly of a cell (the port's counterpart of
``repro.launch.steps``, its ``mesh=None`` path and its mesh path).

A train step is: ``lm.forward`` (each layer rematerialised when
``cfg.remat``; attention through the flash kernel), ``ce_loss``, the
backward (the flash backward kernel, cuBLAS for the matmuls), then AdamW
with a cosine schedule and clipping (``repro_torch.optim``), which
updates the parameters and the optimizer state in place.

On a mesh (``mesh``, ``rules``) the parameters and optimizer state are
DTensors (``lm.place_params``; AdamW keeps their placements, and its
global norm is the norm of the whole gradient), the batch may be plain
(placed by ``lm.forward``).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import lm
from repro_torch.models import partitioning as part
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule
from repro_torch.optim.adamw import AdamWState
from repro_torch.optim.compression import compress_decompress
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten


def ce_loss(cfg, logits, labels, mesh=None, rules=None):
    """Cross-entropy over the (padded) vocab, the mean over every position
    (audio: (B, S, K, V) logits and (B, S, K) labels, every codebook's
    position counted); on a mesh the logits are constrained vocab-sharded
    first, as JAX's, and the loss is taken on each rank's vocab shard
    (``_vocab_parallel``): no rank holds a whole vocab row."""
    lf = logits.float()
    if mesh is not None:
        ax = ("batch", None, None, "vocab") if cfg.n_codebooks else \
            ("batch", None, "vocab")
        lf = part.constrain(lf, mesh, *ax, rules=rules)
        lse, true_logit = _vocab_parallel(lf, labels, mesh, rules)
        return (lse - true_logit).mean()
    lse = torch.logsumexp(lf, dim=-1)
    true_logit = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return (lse - true_logit).mean()


def _vocab_parallel(lf, labels, mesh, rules):
    """(logsumexp, the label's logit) of vocab-sharded fp32 logits, each a
    DTensor (B, S[, K]) reduced over the vocab shards, as GSPMD partitions
    JAX's: the largest logit by a max over the shards, then each rank's
    sum of exp(x - max) and its label's logit (zero where the label is in
    another rank's shard) summed over them. DTensor would gather whole
    vocab rows for the logsumexp and, in the gather's backward, allocate
    the global (B, S, V) gradient on every rank."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    lpl = lf.placements
    vdim = lf.ndim - 1
    vdims = [i for i, p in enumerate(lpl) if isinstance(p, Shard)
             and p.dim == vdim and mesh.size(i) > 1]
    # this rank's first vocab entry: DTensor splits as torch.chunk does
    # (shards of ceil(n / k), the last ones shorter), mesh dim by mesh dim
    coord, v0, n = mesh.get_coordinate(), 0, lf.shape[-1]
    for i in vdims:
        size = -(-n // mesh.size(i))
        v0 += coord[i] * size
        n = max(0, min(size, n - coord[i] * size))
    row = tuple(Replicate() if isinstance(p, Shard) and p.dim == vdim
                else p for p in lpl)
    tok = part.placements_for(part.spec_for(
        ("batch",) + (None,) * (labels.ndim - 1), mesh, rules), mesh)

    if not vdims:                 # whole rows: mesh=None's operators
        return part.local_map(
            lambda x, lab: (torch.logsumexp(x, dim=-1), torch.gather(
                x, -1, lab.long()[..., None])[..., 0]),
            mesh, (lpl, tok), (row, row))(lf, labels)

    def red(op):
        return tuple(Partial(op) if i in vdims else p
                     for i, p in enumerate(row))
    m = part.local_map(lambda x: x.detach().amax(-1), mesh, (lpl,),
                       red("max"))(lf)
    m = part.settle(m)

    def pieces(x, lab, mx):
        idx = lab.long() - v0
        mine = (idx >= 0) & (idx < x.shape[-1])
        t = torch.gather(x, -1, idx.clamp(0, x.shape[-1] - 1)[..., None])
        return (torch.exp(x - mx[..., None]).sum(-1),
                torch.where(mine, t[..., 0], 0.0))
    s, t = part.local_map(pieces, mesh, (lpl, tok, row),
                          (red("sum"), red("sum")))(lf, labels, m)
    return m + torch.log(part.settle(s)), part.settle(t)


def loss_fn(cfg, params, batch, mesh=None, rules=None):
    if mesh is not None:
        batch = lm.place_batch(cfg, batch, mesh, rules)
    logits, aux, _ = lm.forward(cfg, params, batch, mesh=mesh, rules=rules)
    return ce_loss(cfg, logits, batch["labels"], mesh, rules) + aux


def _loss_and_grads_one(cfg, params, batch, mesh, rules):
    leaves, treedef = tree_flatten(params)
    # a batch of patch embeddings (vlm) does not read the token embedding:
    # its gradient is zero, as JAX gives it; every other leaf must be used
    unread = params["embed"] if "embeds" in batch else None
    with torch.enable_grad():
        live = [p.detach().requires_grad_(p is not unread) for p in leaves]
        loss = loss_fn(cfg, tree_unflatten(treedef, live), batch, mesh,
                       rules)
        grads = iter(torch.autograd.grad(
            loss, [t for t in live if t.requires_grad]))
    out = [next(grads) if t.requires_grad else torch.zeros_like(t)
           for t in live]
    return loss.detach(), tree_unflatten(treedef, out)


def loss_and_grads(cfg, params, batch, mesh=None, rules=None):
    """(loss, grads) of one batch: grads is a tree like ``params`` (each
    leaf in its parameter's dtype; fp32 when accumulated); ``params``
    themselves are not marked as requiring grad. With cfg.microbatches > 1
    the batch is split on its batch axis (the leading one; axis 1 of
    "pos3", whose leading axis is its 3 streams) and the gradients of the
    microbatches are summed in fp32 and averaged (memory ↓, same math as
    the JAX package's scan)."""
    nmb = cfg.microbatches
    if nmb <= 1:
        return _loss_and_grads_one(cfg, params, batch, mesh, rules)
    if any(isinstance(v, part.DTensor) for v in batch.values()):
        mbs = _local_microbatches(batch, nmb)
    else:
        mbs = [{k: v.reshape((nmb, v.shape[0] // nmb)
                             + tuple(v.shape[1:]))[i]
                for k, v in batch.items() if k != "pos3"}
               for i in range(nmb)]
        if "pos3" in batch:
            p3 = batch["pos3"]
            p3 = p3.reshape((3, nmb, p3.shape[1] // nmb)
                            + tuple(p3.shape[2:])).transpose(0, 1)
            for i, mb in enumerate(mbs):
                mb["pos3"] = p3[i]
    loss = 0.0
    grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    for i in range(nmb):
        l, g = _loss_and_grads_one(cfg, params, mbs[i], mesh, rules)
        loss = loss + l
        tree_map(lambda acc, x: acc.add_(x), grads, g)
    return loss / nmb, tree_map(lambda g: g / nmb, grads)


def _local_microbatches(batch, nmb):
    """A placed batch (DTensors, the batch axis split over the mesh) cut
    into ``nmb`` microbatches on each rank: microbatch i is every rank's
    i-th block of its local rows (DTensor cannot view a split batch axis
    as (nmb, B / nmb)). Each holds B / nmb rows, as the plain split's do,
    and the sum of their gradients is the whole batch's."""
    out = [{} for _ in range(nmb)]
    for k, v in batch.items():
        ax = 1 if k == "pos3" else 0
        loc = v.to_local()
        n = loc.shape[ax] // nmb
        for i in range(nmb):
            shape = list(v.shape)
            shape[ax] //= nmb
            out[i][k] = part.DTensor.from_local(
                loc.narrow(ax, i * n, n), v.device_mesh, v.placements,
                run_check=False, shape=torch.Size(shape),
                stride=torch.empty(shape, device="meta").stride())
    return out


def make_train_step(cfg, mesh=None, rules=None, *, peak_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics), or, when ``cfg.grad_compression``, train_step(params,
    opt_state, ef_state, batch) -> (params, opt, ef, metrics). Metrics are
    0-d tensors: ``loss``, ``grad_norm``, ``lr``. Params and opt_state are
    updated in place (``optim/adamw.py``). Gradients come from
    ``loss_and_grads`` (microbatched when cfg.microbatches > 1).
    """

    def update(params, opt_state, loss, grads):
        lr = cosine_schedule(opt_state.step, peak_lr=peak_lr, warmup=warmup,
                             total=total_steps)
        params, opt_state, gnorm = adamw_update(grads, opt_state, params,
                                                lr=lr)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "lr": lr}

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(cfg, params, batch, mesh, rules)
        return update(params, opt_state, loss, grads)

    def train_step_compressed(params, opt_state, ef_state, batch):
        """train_step + int8 gradient compression w/ error feedback."""
        if cfg.microbatches > 1:
            raise NotImplementedError("compress after accumulation only")
        loss, grads = loss_and_grads(cfg, params, batch, mesh, rules)
        grads, ef_state = compress_decompress(grads, ef_state)
        params, opt_state, metrics = update(params, opt_state, loss, grads)
        return params, opt_state, ef_state, metrics

    if cfg.grad_compression:
        return train_step_compressed
    return train_step


def make_serve_step(cfg, mesh=None, rules=None):
    """decode: (params, cache, tokens, pos) -> (next_tokens (B,1) (audio:
    (B,1,K)), cache); the cache is updated in place. On a mesh
    (``lm.decode_step``'s) params and cache are DTensors and so are the
    next tokens."""

    def serve_step(params, cache, tokens, pos):
        logits, cache = lm.decode_step(cfg, params, cache, tokens, pos,
                                       mesh=mesh, rules=rules)
        if mesh is not None:         # the vocab whole before its slice
            logits = part.constrain(logits, mesh, "batch",
                                    *(None,) * (logits.ndim - 1),
                                    rules=rules)
        nxt = logits[..., :cfg.vocab_size].argmax(-1).to(torch.int32)
        return nxt[:, None], cache

    return serve_step


def make_prefill_step(cfg, mesh=None, rules=None):
    """prefill: (params, batch) -> (last_logits, decode-format cache); on a
    mesh both are DTensors."""

    def prefill_step(params, batch):
        logits, _, cache = lm.forward(cfg, params, batch, mesh=mesh,
                                      rules=rules, collect_cache=True)
        key = "embeds" if "embeds" in batch else "tokens"
        S = batch[key].shape[1]
        return logits[:, -1], lm.prefill_cache(cfg, cache, S)

    return prefill_step


# ---------------------------------------------------------------------------
# Sharding assembly for a cell
# ---------------------------------------------------------------------------

def shardings_for_cell(cfg, shape, mesh):
    """Everything a train/serve run on ``mesh`` needs: abstract values
    (``meta`` tensors, where JAX has ShapeDtypeStructs) and
    ``partitioning.NamedSharding``s (placements on ``mesh``).

    Returns dict with keys:
      rules, params_abs, params_sh, opt_abs, opt_sh, batch_abs, batch_sh,
      cache_abs, cache_sh, logits_sh (the last three for decode and
      prefill)
    """
    wide = shape.kind == "decode" and shape.global_batch == 1
    rules = part.rules_for(mesh, shape.global_batch, wide_kv=wide)
    params_abs = lm.abstract_params(cfg)
    params_sh = lm.param_shardings(cfg, mesh, rules)
    out: Dict[str, Any] = dict(rules=rules, params_abs=params_abs,
                               params_sh=params_sh)
    # optimizer state shards like params
    out["opt_abs"] = adamw_init(params_abs)
    out["opt_sh"] = AdamWState(step=part.sharding_for((), mesh),
                               m=params_sh, v=params_sh)
    batch_abs, batch_sh = {}, {}
    for name, (shp, dt, logical) in lm.input_defs(cfg, shape).items():
        batch_abs[name] = torch.empty(shp, dtype=getattr(torch, dt),
                                      device="meta")
        batch_sh[name] = part.sharding_for(logical, mesh, rules)
    out["batch_abs"] = batch_abs
    out["batch_sh"] = batch_sh
    if shape.kind in ("decode", "prefill"):
        defs = lm.cache_spec_defs(cfg, shape.seq_len, shape.global_batch)
        out["cache_abs"] = lm.abstract_cache(cfg, shape.seq_len,
                                             shape.global_batch)
        out["cache_sh"] = {n: part.sharding_for(pd.logical, mesh, rules)
                           for n, pd in defs.items()}
        lg_ax = ("batch", None, "vocab") if cfg.n_codebooks else \
            ("batch", "vocab")
        out["logits_sh"] = part.sharding_for(lg_ax, mesh, rules)
    return out
