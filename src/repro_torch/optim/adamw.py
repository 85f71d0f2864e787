"""AdamW with cosine schedule and gradient clipping (the port's
counterpart of ``repro.optim.adamw``, with its constants: b1 0.9, b2 0.95,
eps 1e-8, weight decay 0.1 on leaves of two or more dims, clip 1.0).

``adamw_update`` updates the parameters and both moments IN PLACE (the
``torch.optim`` idiom: at stablelm-1.6b's width a functional update would
hold a second copy of params, m and v, 19.7 GB) and returns the same
tensors; a caller that needs the old values clones them first. The
arithmetic is the JAX package's, in fp32 (``kernels/adamw/ref.py``).

Every leaf goes through the ops ``repro_torch::adamw_sumsq`` and
``repro_torch::adamw_norm`` (the gradient norm and the clipping factor)
and ``repro_torch::adamw_update_`` (every leaf's update): on the card the
hand-written kernels of ``csrc/adamw.cu``, two passes over the leaves
with no host synchronise; on the CPU the plain version. DTensor leaves
(the mesh path) go through them as each rank's local shards: each rank
sums the squares of the shards it alone holds (a leaf replicated over a
mesh dim counts on that dim's first rank only), the ranks add their
partials elementwise, and each finishes the same norm; the update is
elementwise, shard by shard. With the recorder on (``observe.spans``) the
counters ``adamw_elems`` and ``adamw_fused_elems`` add up the elements
updated and those the kernels updated.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels.adamw import ops
from repro_torch.kernels.adamw.ref import grad_norm_ref
from repro_torch.observe import spans
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
    return grad_norm_ref(tree_leaves(tree))


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then a cosine down to ``floor`` ·
    peak_lr at ``total``; a 0-d fp32 tensor on ``step``'s device."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * (s + 1) / max(1, warmup)
    t = torch.clamp((s - warmup) / max(1, total - warmup), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(s < warmup, warm, cos)


def _whole(x):
    """A scalar of the optimizer as a plain tensor: a step placed on a
    mesh (``shardings_for_cell``'s optimizer state) is a DTensor."""
    return x.full_tensor() if isinstance(x, DTensor) else x


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0):
    """Returns (params, new_state, grad_norm); params and the state's m and
    v are updated in place."""
    gl, ml, vl, pl = (tree_leaves(grads), tree_leaves(state.m),
                      tree_leaves(state.v), tree_leaves(params))
    step = state.step + 1
    t = _whole(step).to(torch.float32)
    bc1 = 1 - torch.pow(b1, t)
    bc2 = 1 - torch.pow(b2, t)
    mesh = pl[0].device_mesh if isinstance(pl[0], DTensor) else None
    norm_in = gl
    if mesh is not None:
        gl = [g.redistribute(mesh, p.placements) for g, p in zip(gl, pl)]
        coord = mesh.get_coordinate()
        norm_in = [g.to_local() if all(
            pl_.is_shard() or c == 0 for pl_, c in zip(g.placements, coord))
            else g.to_local().new_empty(0) for g in gl]
        pl, gl, ml, vl = ([x.to_local() for x in xs]
                          for xs in (pl, gl, ml, vl))
    partial = ops.adamw_sumsq(norm_in)
    if mesh is not None:
        from torch.distributed import _functional_collectives as funcol
        for d in range(mesh.ndim):
            if mesh.size(d) > 1:
                partial = funcol.wait_tensor(funcol.all_reduce(
                    partial, "sum", mesh.get_group(d)))
    gnorm, scale = ops.adamw_norm(partial, clip_norm)
    dev = pl[0].device
    lr = _whole(lr).to(dev, torch.float32) if isinstance(lr, torch.Tensor) \
        else torch.full((), lr, dtype=torch.float32, device=dev)
    ops.adamw_update_(pl, gl, ml, vl, scale, lr, bc1, bc2, b1=b1, b2=b2,
                      eps=eps, weight_decay=weight_decay)
    if spans.on():
        n = sum(p.numel() for p in pl)
        spans.count("adamw_elems", n)
        spans.count("adamw_fused_elems", n if pl[0].is_cuda else 0)
    return params, AdamWState(step, state.m, state.v), gnorm
