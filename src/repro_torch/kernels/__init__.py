"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions."""

import torch


def needs_grad(*tensors) -> bool:
    """Whether autograd would differentiate through a call on these: the
    paged decode op, whose kernel has no backward, raises then, on CUDA
    tensors, rather than return a result that silently drops the gradient,
    and so does the flash op at head dims its backward kernel does not
    take (flash attention and the SSD otherwise differentiate through
    their backward kernels)."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)
