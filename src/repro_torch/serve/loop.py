"""Batched serving loop: prefill once, then one greedy decode step per
token over a cache updated in place (K/V for attention layers, SSM and
conv states for Mamba2 layers)."""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import lm


class ServeLoop:
    def __init__(self, cfg, params, *, max_len: int = 256, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        # matrices cast to the compute dtype once (the values every use
        # would cast them to); norm scales stay as they are
        self.params = lm.cast_params(cfg, params, cfg.compute_dt())
        self.max_len = max_len
        self.prefill = make_prefill_step(cfg)
        self.step = make_serve_step(cfg)

    @torch.inference_mode()
    def generate(self, prompt_tokens, n_new: int):
        """prompt_tokens: (B, S0) ints (audio: (B, S0, K)). Greedy-decodes
        ``n_new`` tokens and returns them as a (B, n_new) (audio:
        (B, n_new, K)) int32 tensor on the loop's device."""
        cfg = self.cfg
        tokens = torch.as_tensor(prompt_tokens, device=self.device) \
            .to(torch.int32)
        S0 = tokens.shape[1]
        logits, cache = self.prefill(self.params, {"tokens": tokens})
        cache = lm.grow_cache(cfg, cache, self.max_len)

        nxt = logits[..., :cfg.vocab_size].argmax(-1).to(torch.int32)[:, None]
        out = [nxt]
        pos = S0
        for _ in range(n_new - 1):
            nxt, cache = self.step(self.params, cache, nxt, pos)
            out.append(nxt)
            pos += 1
        return torch.cat(out, dim=1)
