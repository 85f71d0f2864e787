"""Batched serving loop: prefill once, then one greedy decode step per
token over a cache updated in place (K/V for attention layers, SSM and
conv states for Mamba2 layers).

With a mesh (``mesh``, ``rules``) the prefill runs on it, on parameters
placed by ``lm.param_specs``, and decode runs on the whole values, as the
JAX package's loop decodes without a mesh.

Each generate is a ``serve_generate`` span; inside it the prefill (with
the cache's growth and the first arg-max) is ``serve_prefill`` and each
decode step ``serve_decode``, both marked on the loop's device
(``repro_torch.observe.spans``)."""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import lm
from repro_torch.models import partitioning as part
from repro_torch.observe import spans
from repro_torch.tree import tree_map


class ServeLoop:
    def __init__(self, cfg, params, *, max_len: int = 256, mesh=None,
                 rules=None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        # matrices cast to the compute dtype once (the values every use
        # would cast them to); norm scales stay as they are
        self.params = lm.cast_params(cfg, params, cfg.compute_dt())
        self.max_len = max_len
        self.mesh = mesh
        self.prefill_params = self.params if mesh is None else \
            lm.place_params(cfg, self.params, mesh, rules)
        self.prefill = make_prefill_step(cfg, mesh, rules)
        self.step = make_serve_step(cfg)

    def generate(self, prompt_tokens, n_new: int):
        """prompt_tokens: (B, S0) ints (audio: (B, S0, K)). Greedy-decodes
        ``n_new`` tokens and returns them as a (B, n_new) (audio:
        (B, n_new, K)) int32 tensor on the loop's device. Runs under
        inference mode, or under no_grad on a mesh (DTensors keep
        autograd's version counters, which inference mode does not)."""
        with spans.span("serve_generate"), \
                torch.inference_mode() if self.mesh is None else \
                torch.no_grad():
            return self._generate(prompt_tokens, n_new)

    def _generate(self, prompt_tokens, n_new):
        cfg = self.cfg
        tokens = torch.as_tensor(prompt_tokens, device=self.device) \
            .to(torch.int32)
        S0 = tokens.shape[1]
        with spans.span("serve_prefill", mark=self.device):
            logits, cache = self.prefill(self.prefill_params,
                                         {"tokens": tokens})
            if self.mesh is not None:
                logits, cache = part.full(logits), tree_map(part.full, cache)
            cache = lm.grow_cache(cfg, cache, self.max_len)
            nxt = logits[..., :cfg.vocab_size].argmax(-1) \
                .to(torch.int32)[:, None]
        out = [nxt]
        pos = S0
        for _ in range(n_new - 1):
            with spans.span("serve_decode", mark=self.device):
                nxt, cache = self.step(self.params, cache, nxt, pos)
            out.append(nxt)
            pos += 1
        return torch.cat(out, dim=1)
