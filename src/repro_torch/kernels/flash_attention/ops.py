"""Flash attention with its gradient: the CUDA kernels on CUDA tensors,
the plain versions on CPU tensors (and on nothing else), as the torch
custom ops ``repro_torch::flash_fwd``, ``flash_fwd_lse`` (the forward
with its lse) and ``flash_bwd`` (``kernels.kernel_op``; on fake tensors
the output shapes alone, with ``roofline.work``'s FLOPs for
``FlopCounterMode``).

``FlashAttention`` is the port's counterpart of the JAX ``custom_vjp`` of
``repro/models/attention.py:_flash_core``: its forward and backward call
the ops; the forward saves (q, k, v, o, lse), with the un-repeated k/v,
and the backward recomputes the scores block by block from them.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import kernel_op, reject_dtensor
from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd,
                                                        flash_attention_fwd)
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_fwd_ref)
from repro_torch.roofline import work

Tensor = torch.Tensor


def _fwd(q: Tensor, k: Tensor, v: Tensor, causal: bool, window: int,
         scale: float, q_chunk: int, k_chunk: int, schedule: str) -> Tensor:
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(
            q, k, v, causal=causal, window=window, scale=scale,
            q_chunk=q_chunk, k_chunk=k_chunk, schedule=schedule)[0] \
            .contiguous()
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               scale=scale)


def _fwd_lse(q: Tensor, k: Tensor, v: Tensor, causal: bool, window: int,
             scale: float, q_chunk: int, k_chunk: int,
             schedule: str) -> tuple[Tensor, Tensor]:
    if q.device.type == "cpu":
        o, lse = flash_attention_fwd_ref(
            q, k, v, causal=causal, window=window, scale=scale,
            q_chunk=q_chunk, k_chunk=k_chunk, schedule=schedule)
        return o.contiguous(), lse.contiguous()
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               scale=scale, with_lse=True)


def _bwd(q: Tensor, k: Tensor, v: Tensor, o: Tensor, lse: Tensor,
         do: Tensor, causal: bool, window: int, scale: float, q_chunk: int,
         k_chunk: int, schedule: str) -> tuple[Tensor, Tensor, Tensor]:
    if q.device.type == "cpu":
        return tuple(t.contiguous() for t in flash_attention_bwd_ref(
            q, k, v, o, lse, do, causal=causal, window=window, scale=scale,
            q_chunk=q_chunk, k_chunk=k_chunk, schedule=schedule))
    return flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                               window=window, scale=scale)


def _o_like(q, v):
    return q.new_empty((*q.shape[:3], v.shape[-1]))


def _fake_fwd(q, k, v, causal, window, scale, q_chunk, k_chunk, schedule):
    return _o_like(q, v)


def _fake_fwd_lse(q, k, v, causal, window, scale, q_chunk, k_chunk,
                  schedule):
    B, S, H = q.shape[:3]
    return _o_like(q, v), q.new_empty((B, H, S), dtype=torch.float32)


def _fake_bwd(q, k, v, o, lse, do, causal, window, scale, q_chunk, k_chunk,
              schedule):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _flops(name):
    def formula(*args, out_shape=None, **kwargs):
        return work.op_work(name, args)[1]
    return formula


fwd_op = kernel_op("flash_fwd", _fwd, _fake_fwd, _flops("flash_fwd"))
fwd_lse_op = kernel_op("flash_fwd_lse", _fwd_lse, _fake_fwd_lse,
                       _flops("flash_fwd_lse"))
bwd_op = kernel_op("flash_bwd", _bwd, _fake_bwd, _flops("flash_bwd"))


class FlashAttention(torch.autograd.Function):
    """apply(q, k, v, causal, window, scale, q_chunk, k_chunk, schedule).

    The kernels write lse only when a gradient is needed, so a serving
    call launches the forward exactly as without autograd."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_chunk, k_chunk,
                schedule):
        reject_dtensor(q, k, v)
        opts = (causal, window, scale, q_chunk, k_chunk, schedule)
        if any(ctx.needs_input_grad[:3]):
            o, lse = fwd_lse_op(q, k, v, *opts)
            ctx.save_for_backward(q, k, v, o, lse)
            ctx.opts = opts
            return o
        return fwd_op(q, k, v, *opts)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = bwd_op(q, k, v, o, lse, do, *ctx.opts)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None, q_chunk: int = 512,
                    k_chunk: int = 0, schedule: str = "triangular"):
    """q: (B, S, H, hd); k: (B, Sk, KH, hd), v: (B, Sk, KH, hd_v).
    Returns (B, S, H, hd_v), differentiable in q, k and v (on the card at
    the head dims both kernels take: one for q, k and v, or MLA's
    (192, 128)). A DTensor raises ``TypeError``."""
    reject_dtensor(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return FlashAttention.apply(q, k, v, bool(causal), int(window),
                                float(scale), int(q_chunk), int(k_chunk),
                                schedule)
