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


# the kernel ops' namespace, ``torch.ops.repro_torch`` (registered at the
# dispatcher's level: a torch.library.custom_op costs the host ~20 us more
# a call, and decode makes 24-63 such calls a step)
_LIB = torch.library.Library("repro_torch", "DEF")


def kernel_op(name: str, route, fake, flops=None):
    """Register ``route`` as the torch op ``repro_torch::<name>``
    (``torch.ops.repro_torch.<name>``, its schema inferred from ``route``'s
    annotations): its CPU and CUDA implementation, ``route``, runs the
    plain version on a CPU tensor and the hand-written kernel's wrapper on
    a CUDA tensor; ``fake``, the output shapes, dtypes and strides alone,
    which ``FakeTensorMode`` runs in place of either on a fake tensor of
    any device (a trace takes the card's route and launches nothing); and
    ``flops``, ``FlopCounterMode``'s formula (of shapes, from
    ``roofline.work``). Returns a function that calls the op, except on a
    ``meta`` tensor, which it hands to ``route`` itself: the kernel's
    wrapper then refuses it, as it refuses any tensor off the card."""
    from torch.utils.flop_counter import register_flop_formula
    _LIB.define(name + torch.library.infer_schema(route, mutates_args=()))
    for key in ("CPU", "CUDA"):
        _LIB.impl(name, route, key)
    torch.library.register_fake(f"repro_torch::{name}", fake, lib=_LIB)
    packet = getattr(torch.ops.repro_torch, name)
    if flops is not None:
        register_flop_formula(packet)(flops)

    def call(*args):
        if args[0].device.type == "meta":
            return route(*args)
        return packet(*args)
    return call
