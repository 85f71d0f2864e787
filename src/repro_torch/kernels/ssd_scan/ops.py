"""Full SSD = the intra-chunk pieces (the CUDA kernels on CUDA tensors,
the plain versions on CPU tensors and on nothing else) + the linear
inter-chunk recurrence, which stays plain PyTorch as it stays jnp around
the Pallas kernel (``repro/kernels/ssd_scan/ops.py``) and is
differentiated by autograd.

``SSDChunk`` differentiates the pieces: on CUDA tensors its forward is
the chunk kernel ``ssd_chunk_call`` and its backward the hand-written
``ssd_chunk_bwd`` (``csrc/ssd_bwd.cu``); on CPU tensors ``ssd_chunk_ref``
and its explicit gradient ``ssd_chunk_bwd_ref``. The forward saves only
its inputs and the backward recomputes cs and L, as the JAX package's
``ssd_chunked`` recomputes each chunk under ``jax.checkpoint``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.kernel import ssd_chunk_bwd, ssd_chunk_call
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_bwd_ref, ssd_chunk_ref


class SSDChunk(torch.autograd.Function):
    """apply(x, dt, A_log, B_, C_, chunk) -> (y_diag, states, exp_cs,
    exp_tot), as ``ssd_chunk_call``. A call that needs no gradient saves
    nothing and launches the forward kernel alone."""

    @staticmethod
    def forward(ctx, x, dt, A_log, B_, C_, chunk):
        pieces = ssd_chunk_ref if x.device.type == "cpu" else ssd_chunk_call
        out = pieces(x, dt, A_log, B_, C_, chunk=chunk)
        if any(ctx.needs_input_grad[:5]):
            ctx.save_for_backward(x, dt, A_log, B_, C_)
            ctx.chunk = chunk
        return out

    @staticmethod
    def backward(ctx, dy, dst, decs, detot):
        x, dt, A_log, B_, C_ = ctx.saved_tensors
        grad = ssd_chunk_bwd_ref if x.device.type == "cpu" else ssd_chunk_bwd
        cot = [t.float().contiguous() for t in (dy, dst, decs, detot)]
        dx, ddt, dA_log, dB, dC = grad(x, dt, A_log, B_, C_, *cot,
                                       chunk=ctx.chunk)
        return dx, ddt, dA_log, dB, dC, None


def ssd(x, dt, A_log, B_, C_, D_, *, chunk: int = 256, state=None):
    """x: (B, S, nh, hp); dt: (B, S, nh) (post-softplus, fp32); A_log, D_:
    (nh,); B_/C_: (B, S, ns); state: (B, nh, hp, ns) or None.
    Returns (y (B, S, nh, hp) in x's dtype, final_state fp32)."""
    B, S, nh, hp = x.shape
    ns = B_.shape[-1]
    cl = min(chunk, S)
    S_orig = S
    if S % cl:                 # pad with dt=0 tokens (state-neutral)
        pad = cl - S % cl
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, pad))
        S = S + pad
    nc = S // cl

    y_diag, states, exp_cs, exp_tot = SSDChunk.apply(x, dt, A_log.float(),
                                                     B_, C_, chunk)

    if state is None:
        state = torch.zeros((B, nh, hp, ns), dtype=torch.float32,
                            device=x.device)
    C_c = C_.reshape(B, nc, cl, ns).float()
    y_off = []
    for c in range(nc):        # jax.lax.scan over the chunks
        y_off.append(torch.einsum("bin,bhpn,bih->bihp", C_c[:, c], state,
                                  exp_cs[:, c]))
        state = state * exp_tot[:, c, :, None, None] + states[:, c]
    y = (y_diag + torch.stack(y_off, dim=1)).reshape(B, S, nh, hp)
    y = y + x.float() * D_.float()[None, None, :, None]
    return y.to(x.dtype)[:, :S_orig], state
