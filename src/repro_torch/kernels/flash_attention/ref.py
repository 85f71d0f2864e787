"""Plain PyTorch version of the flash attention kernel (O(S²) memory)."""

from repro_torch.models import attention as _attn


def flash_attention_ref(q, k, v, *, causal=True, window=0, scale=None):
    return _attn.reference_attention(q, k, v, causal=causal, window=window,
                                     scale=scale)
