"""train_step / serve_step / prefill_step factories and the LM loss (the
port's counterpart of ``repro.launch.steps`` on the ``mesh=None`` path).

A train step is: ``lm.forward`` (each layer rematerialised when
``cfg.remat``; attention through the flash kernel), ``ce_loss``, the
backward (the flash backward kernel, cuBLAS for the matmuls), then AdamW
with a cosine schedule and clipping (``repro_torch.optim``), which
updates the parameters and the optimizer state in place.
"""

from __future__ import annotations

import torch

from repro_torch.models import lm
from repro_torch.optim import adamw_update, cosine_schedule
from repro_torch.optim.compression import compress_decompress
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten


def ce_loss(cfg, logits, labels):
    """Cross-entropy over the (padded) vocab."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    true_logit = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return (lse - true_logit).mean()


def loss_fn(cfg, params, batch):
    logits, aux, _ = lm.forward(cfg, params, batch)
    return ce_loss(cfg, logits, batch["labels"]) + aux


def _loss_and_grads_one(cfg, params, batch):
    leaves, treedef = tree_flatten(params)
    with torch.enable_grad():
        live = [p.detach().requires_grad_() for p in leaves]
        loss = loss_fn(cfg, tree_unflatten(treedef, live), batch)
        grads = torch.autograd.grad(loss, live)
    return loss.detach(), tree_unflatten(treedef, list(grads))


def loss_and_grads(cfg, params, batch):
    """(loss, grads) of one batch: grads is a tree like ``params`` (each
    leaf in its parameter's dtype; fp32 when accumulated); ``params``
    themselves are not marked as requiring grad. With cfg.microbatches > 1
    the batch is split on the leading axis and the gradients of the
    microbatches are summed in fp32 and averaged (memory ↓, same math as
    the JAX package's scan)."""
    nmb = cfg.microbatches
    if nmb <= 1:
        return _loss_and_grads_one(cfg, params, batch)
    mbs = {k: v.reshape((nmb, v.shape[0] // nmb) + tuple(v.shape[1:]))
           for k, v in batch.items()}
    loss = 0.0
    grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    for i in range(nmb):
        l, g = _loss_and_grads_one(cfg, params,
                                   {k: v[i] for k, v in mbs.items()})
        loss = loss + l
        tree_map(lambda acc, x: acc.add_(x), grads, g)
    return loss / nmb, tree_map(lambda g: g / nmb, grads)


def make_train_step(cfg, *, peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000):
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
        loss, grads = loss_and_grads(cfg, params, batch)
        return update(params, opt_state, loss, grads)

    def train_step_compressed(params, opt_state, ef_state, batch):
        """train_step + int8 gradient compression w/ error feedback."""
        if cfg.microbatches > 1:
            raise NotImplementedError("compress after accumulation only")
        loss, grads = loss_and_grads(cfg, params, batch)
        grads, ef_state = compress_decompress(grads, ef_state)
        params, opt_state, metrics = update(params, opt_state, loss, grads)
        return params, opt_state, ef_state, metrics

    if cfg.grad_compression:
        return train_step_compressed
    return train_step


def make_serve_step(cfg):
    """decode: (params, cache, tokens, pos) -> (next_tokens (B,1), cache);
    the cache is updated in place."""

    def serve_step(params, cache, tokens, pos):
        logits, cache = lm.decode_step(cfg, params, cache, tokens, pos)
        nxt = logits[..., :cfg.vocab_size].argmax(-1).to(torch.int32)
        return nxt[:, None], cache

    return serve_step


def make_prefill_step(cfg):
    """prefill: (params, batch) -> (last_logits, decode-format cache)."""

    def prefill_step(params, batch):
        logits, _, cache = lm.forward(cfg, params, batch, collect_cache=True)
        S = batch["tokens"].shape[1]
        return logits[:, -1], lm.prefill_cache(cfg, cache, S)

    return prefill_step
