"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions."""

import torch


def needs_grad(*tensors) -> bool:
    """Whether autograd would differentiate through a call on these: an op
    whose kernel has no backward raises then, on CUDA tensors, rather than
    return a result that silently drops the gradient."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)
