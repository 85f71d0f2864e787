"""Int8 gradient compression with error feedback (the port's counterpart of
``repro.optim.compression``).

Gradients are quantized to int8 with a per-tensor scale before the
data-parallel reduction (4× less reduce-scatter traffic than fp32) and
the quantization error is carried to the next step (error feedback),
which keeps SGD/Adam convergence (Seide et al.; Karimireddy et al.).

Usage (train loop):
    state = ef_init(grads)
    grads_q, state = compress_decompress(grads, state)   # before adamw
"""

from __future__ import annotations

import torch

from repro_torch.tree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten


def ef_init(tree):
    """Error-feedback residuals, one per leaf (fp32)."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), tree)


def quantize_int8(x):
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def compress_decompress(grads, ef_state):
    """Simulates the compressed all-reduce path: quantize (what the wire
    would carry), dequantize, and fold the quantization error into the
    next step's gradients. Returns (grads_hat, new_ef_state)."""
    leaves, treedef = tree_flatten(grads)
    g_hat, new_ef = [], []
    for g, e in zip(leaves, tree_leaves(ef_state)):
        gf = g.float() + e
        q, scale = quantize_int8(gf)
        gh = dequantize_int8(q, scale)
        g_hat.append(gh)
        new_ef.append(gf - gh)
    return tree_unflatten(treedef, g_hat), tree_unflatten(treedef, new_ef)


def wire_bytes(tree, dtype_bytes: int = 4) -> int:
    """Bytes a reduction of this tree would move uncompressed vs int8."""
    return sum(x.numel() for x in tree_leaves(tree)) * dtype_bytes
