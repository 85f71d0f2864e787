"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions."""

import torch
from torch.distributed.tensor import DTensor


def needs_grad(*tensors) -> bool:
    """Whether autograd would differentiate through a call on these: the
    paged decode op, whose kernel has no backward, raises then, on CUDA
    tensors, rather than return a result that silently drops the gradient,
    and so does the flash op at head dims its backward kernel does not
    take (flash attention and the SSD otherwise differentiate through
    their backward kernels)."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def reject_dtensor(*tensors) -> None:
    """Kernel ops take plain tensors: their kernels bind raw pointers and
    their plain versions would run on one shard as if it were the whole.
    A DTensor raises ``TypeError``, on every device type; the mesh path
    hands a kernel op local shards (``partitioning.local_map``)."""
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError("a kernel op takes plain tensors, not DTensors: "
                        "call it on local shards (partitioning.local_map)")
