"""PyTorch/CUDA port of the ``repro`` model substrate.

Mirrors ``repro``'s module paths and public names; imports ``torch`` and
numpy, never JAX and never the ``repro`` package. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on CPU tensors every
kernel op runs its plain PyTorch version, on CUDA tensors it launches its
hand-written kernel or raises.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. Asking for CUDA without a card
    raises: nothing falls back to the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
