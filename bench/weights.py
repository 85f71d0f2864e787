"""Weights made from the seed, one generator a leaf and a layer, so that
the program's whole tree and the reference's one layer at a time are the
same numbers.

The layout is the program's parameter tree (``spec``): stacked leaves of
shape (layers, ...) under ``dense_layers`` and ``layers``, each layer's
as the configuration's model module lays it out (``block_leaves``,
``bench/reference``), the rest unstacked. Each (leaf, layer) slice is
N(0, 1 / fan_in) (fan_in the slice's second-to-last axis), drawn in fp32
on the device from its own ``torch.Generator`` seeded by a hash of
(seed, leaf, layer); norm scales are ones. Served weights are the bf16
rounding of those draws (the leaves the module marks fp32, such as norm
scales and the router, stay fp32, as the program reads them); trained
weights are the fp32 draws.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch


@dataclass(frozen=True)
class Leaf:
    path: Tuple[str, ...]          # keys from the root of the tree
    shape: Tuple[int, ...]         # one layer's slice (or the whole leaf)
    layers: Optional[int] = None   # stacked over this many layers
    ones: bool = False             # a norm scale
    fp32: bool = False             # read in fp32 when served in bf16

    @property
    def name(self) -> str:
        return ".".join(self.path)

    @property
    def stacked_ndim(self) -> int:
        return len(self.shape) + (1 if self.layers is not None else 0)


def stacks(m: dict) -> List[Tuple[str, int, bool]]:
    """(stack name, layers, MoE layers?) in the order the model runs them."""
    if m.get("moe"):
        fk = m["moe"].get("first_k_dense", 0)
        out = [("dense_layers", fk, False)] if fk else []
        return out + [("layers", m["n_layers"] - fk, True)]
    return [("layers", m["n_layers"], False)]


def spec(m: dict, ref) -> List[Leaf]:
    """Every leaf of the program's tree, for the model description ``m``
    whose layers the model module ``ref`` lays out."""
    d, V = m["d_model"], m["vocab_size"]
    out = [Leaf(("embed",), (V, d)),
           Leaf(("final_norm",), (d,), ones=True, fp32=True),
           Leaf(("head",), (d, V))]
    for name, n, moe_layer in stacks(m):
        out += [Leaf((name,) + p, tuple(shape), n, ones, fp32)
                for p, shape, ones, fp32 in ref.block_leaves(m, moe_layer)]
    return out


def _seed_of(seed: int, leaf: Leaf, layer: Optional[int]) -> int:
    h = hashlib.sha256(f"{seed}/{leaf.name}/{layer}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def draw(seed: int, leaf: Leaf, layer: Optional[int], device) -> torch.Tensor:
    """One slice (one layer of a stacked leaf) in fp32."""
    if leaf.ones:
        return torch.ones(leaf.shape, dtype=torch.float32, device=device)
    g = torch.Generator(device=device).manual_seed(_seed_of(seed, leaf, layer))
    fan_in = leaf.shape[-2] if len(leaf.shape) >= 2 else leaf.shape[-1]
    w = torch.randn(leaf.shape, generator=g, dtype=torch.float32,
                    device=device)
    return w.mul_(fan_in ** -0.5)


def served_dtype(leaf: Leaf, dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if leaf.fp32 else dtype


def slice_as(seed: int, leaf: Leaf, layer: Optional[int], device,
             dtype: torch.dtype) -> torch.Tensor:
    """The slice as the program holds it (``dtype`` for matrices), upcast
    to fp32: what the reference computes with."""
    w = draw(seed, leaf, layer, device)
    return w.to(served_dtype(leaf, dtype)).float()


def make_tree(leaves: List[Leaf], seed: int, device,
              dtype: torch.dtype) -> dict:
    """The program's whole parameter tree of ``leaves`` (``spec``):
    matrices in ``dtype``, fp32 leaves in fp32; stacked leaves filled a
    layer at a time."""
    tree: Dict = {}
    for leaf in leaves:
        dt = served_dtype(leaf, dtype)
        if leaf.layers is None:
            t = draw(seed, leaf, None, device).to(dt)
        else:
            t = torch.empty((leaf.layers,) + leaf.shape, dtype=dt,
                            device=device)
            for i in range(leaf.layers):
                t[i].copy_(draw(seed, leaf, i, device))
        node = tree
        for k in leaf.path[:-1]:
            node = node.setdefault(k, {})
        node[leaf.path[-1]] = t
    return tree


def get(tree: dict, path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree
