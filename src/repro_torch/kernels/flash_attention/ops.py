"""Flash attention forward: the CUDA kernel on CUDA tensors, the plain
version on CPU tensors (and on nothing else)."""

from __future__ import annotations

from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None):
    """q: (B, S, H, hd); k/v: (B, Sk, KH, hd). Returns (B, S, H, hd)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               scale=scale)
