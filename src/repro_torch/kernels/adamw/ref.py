"""Plain PyTorch version of the AdamW kernels: the port's AdamW arithmetic
(the JAX package's, ``repro/optim/adamw.py:56-62``, in fp32), a handful of
elementwise kernels a leaf. It is the CPU route of ``repro_torch::
adamw_sumsq``, ``adamw_norm`` and ``adamw_update_``, and what the kernels
are held to on the card."""

from __future__ import annotations

import torch


def grad_norm_ref(grads) -> torch.Tensor:
    """The global L2 norm of the leaves ``grads``, in fp32: each leaf's sum
    of squares, then their sum."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in grads))


def adamw_sumsq_ref(grads) -> torch.Tensor:
    """Each leaf's sum of squares, in fp32: the (len(grads),) partials
    ``adamw_norm_ref`` finishes."""
    return torch.stack([torch.sum(torch.square(x.float())) for x in grads])


def adamw_norm_ref(partial, clip_norm: float):
    """(gnorm, scale): the square root of the partials' sum, added in
    order as ``grad_norm_ref`` adds its leaves, and the clipping factor
    ``min(1, clip_norm / max(gnorm, 1e-9))``, both 0-d fp32."""
    gnorm = torch.sqrt(sum(partial.unbind(0)))
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return gnorm, scale


def adamw_update_ref(params, grads, m, v, scale, lr, bc1, bc2, b1: float,
                     b2: float, eps: float, weight_decay: float) -> None:
    """Update each leaf of ``params`` and its moments ``m`` and ``v`` IN
    PLACE from its gradient scaled by ``scale``, at learning rate ``lr``
    with the bias corrections ``bc1`` and ``bc2``; weight decay only on
    leaves of two or more dims."""
    for g, m_, v_, p in zip(grads, m, v, params):
        g = g.float() * scale
        m_.mul_(b1).add_((1 - b1) * g)
        v_.mul_(b2).add_((1 - b2) * torch.square(g))
        u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
        decay = weight_decay if p.ndim >= 2 else 0.0
        pf = p.float()
        p.copy_(pf - lr * (u + decay * pf))
