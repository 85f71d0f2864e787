"""serve_step / prefill_step factories and the LM loss (the port's
counterpart of ``repro.launch.steps``; the train step comes with the
training slice)."""

from __future__ import annotations

import torch

from repro_torch.models import lm


def ce_loss(cfg, logits, labels):
    """Cross-entropy over the (padded) vocab."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    true_logit = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return (lse - true_logit).mean()


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
