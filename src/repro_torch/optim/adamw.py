"""AdamW with cosine schedule and gradient clipping (the port's
counterpart of ``repro.optim.adamw``, with its constants: b1 0.9, b2 0.95,
eps 1e-8, weight decay 0.1 on leaves of two or more dims, clip 1.0).

``adamw_update`` updates the parameters and both moments IN PLACE (the
``torch.optim`` idiom: at stablelm-1.6b's width a functional update would
hold a second copy of params, m and v, 19.7 GB) and returns the same
tensors; a caller that needs the old values clones them first. The
arithmetic is the JAX package's, in fp32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32
    m: dict                  # like params, fp32
    v: dict                  # like params, fp32


def adamw_init(params) -> AdamWState:
    """Zero moments like ``params`` (DTensors with their placements)."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)
    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then a cosine down to ``floor`` ·
    peak_lr at ``total``; a 0-d fp32 tensor on ``step``'s device."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * (s + 1) / max(1, warmup)
    t = torch.clamp((s - warmup) / max(1, total - warmup), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(s < warmup, warm, cos)


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0):
    """Returns (params, new_state, grad_norm); params and the state's m and
    v are updated in place."""
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    t = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, t)
    bc2 = 1 - torch.pow(b2, t)
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.m),
                          tree_leaves(state.v), tree_leaves(params)):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        decay = weight_decay if p.ndim >= 2 else 0.0
        pf = p.float()
        p.copy_(pf - lr * (u + decay * pf))
    return params, AdamWState(step, state.m, state.v), gnorm
