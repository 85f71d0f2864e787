"""Flash attention with its gradient: the CUDA kernels on CUDA tensors,
the plain versions on CPU tensors (and on nothing else).

``FlashAttention`` is the port's counterpart of the JAX ``custom_vjp`` of
``repro/models/attention.py:_flash_core``: the forward saves
(q, k, v, o, lse), with the un-repeated k/v, and the backward recomputes
the scores block by block from them.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd,
                                                        flash_attention_fwd)
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_fwd_ref)


class FlashAttention(torch.autograd.Function):
    """apply(q, k, v, causal, window, scale, q_chunk, k_chunk, schedule).

    The kernels write lse only when a gradient is needed, so a serving
    call launches the forward exactly as without autograd."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_chunk, k_chunk,
                schedule):
        need_grad = any(ctx.needs_input_grad[:3])
        if q.device.type == "cpu":
            o, lse = flash_attention_fwd_ref(
                q, k, v, causal=causal, window=window, scale=scale,
                q_chunk=q_chunk, k_chunk=k_chunk, schedule=schedule)
        elif need_grad:
            o, lse = flash_attention_fwd(q, k, v, causal=causal,
                                         window=window, scale=scale,
                                         with_lse=True)
        else:
            o = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                    scale=scale)
        if need_grad:
            ctx.save_for_backward(q, k, v, o, lse)
            ctx.opts = dict(causal=causal, window=window, scale=scale)
            ctx.chunks = dict(q_chunk=q_chunk, k_chunk=k_chunk,
                              schedule=schedule)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                 **ctx.opts, **ctx.chunks)
        else:
            dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None, q_chunk: int = 512,
                    k_chunk: int = 0, schedule: str = "triangular"):
    """q: (B, S, H, hd); k: (B, Sk, KH, hd), v: (B, Sk, KH, hd_v).
    Returns (B, S, H, hd_v), differentiable in q, k and v (on the card at
    the head dims both kernels take: one for q, k and v, or MLA's
    (192, 128))."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return FlashAttention.apply(q, k, v, bool(causal), int(window),
                                float(scale), int(q_chunk), int(k_chunk),
                                schedule)
