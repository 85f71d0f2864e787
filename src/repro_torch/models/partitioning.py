"""Logical-axis → mesh-axis partitioning rules (the port's counterpart of
``repro.models.partitioning``), on DTensor.

Params and activations are annotated with *logical* axis names; a rule set
maps them to mesh axes. One rule table serves the single-pod
``("data", "model")`` mesh and the multi-pod ``("pod", "data", "model")``
mesh: axes absent from the mesh are dropped.

* ``embed``   → ``data`` (+``pod``): FSDP/ZeRO-3-style parameter sharding.
* ``heads`` / ``mlp`` / ``vocab`` → ``model``: tensor parallelism.
* ``kv_heads`` → replicated: GQA archs have 1–8 KV heads, which does not
  divide the 16-wide model axis.
* ``experts`` → ``model``; ``act_seq`` → ``model`` (the residual stream
  between blocks is sequence-sharded); ``kv_seq`` → ``model`` (decode
  caches), spread over ``pod``+``data`` too for batch-1 decode
  (``rules_for(wide_kv=True)``).

``spec_for`` returns what JAX's returns, as a tuple: one entry a tensor
dim, each ``None``, a mesh-axis name or a tuple of names (in mesh order,
major to minor). ``placements_for`` turns it into DTensor placements, one
a mesh dim; ``constrain`` is JAX's ``with_sharding_constraint``: a
redistribution that never changes a value. ``local_map`` is JAX's
``shard_map``: a function of local shards (a kernel call, a group-local
MoE dispatch) applied to DTensors, so no DTensor ever reaches a kernel op.

The rule functions take any mesh with axis names and sizes: a
``DeviceMesh`` or a shape-only stand-in with ``axis_names`` and a
``shape`` mapping (as ``tests/test_roofline.py``'s ``FakeMesh``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import local_map as _local_map

# logical axis -> tuple of candidate mesh axes (joined, in order, if present)
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "act_seq": ("model",),
    "embed": ("data",),
    "embed_wide": ("pod", "data"),   # used for FSDP of params in multi-pod
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": (),                  # replicated (see module docstring)
    "mlp": ("model",),
    "experts": ("model",),
    "expert_mlp": ("model",),
    "expert_ffn": ("data",),   # output-dim FSDP for expert weights
    "kv_seq": ("model",),
    "kv_seq_wide": ("pod", "data", "model"),
    "layers": (),
    "conv": (),
    "ssm_heads": ("model",),
    "ssm_heads_rep": (),             # mamba2-130m: 24 heads don't divide 16
    "ssm_state": (),
    None: (),
}


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where a tensor lives: the mesh and one placement a mesh dim (the
    counterpart of ``jax.sharding.NamedSharding``; a leaf of the port's
    trees)."""
    mesh: object
    placements: tuple


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or of a stand-in with
    ``axis_names`` and a ``shape`` mapping, in mesh order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: mesh.shape[a] for a in mesh.axis_names}


def spec_for(logical: Sequence[Optional[str]], mesh,
             rules: Optional[dict] = None) -> tuple:
    """The partition spec of a tuple of logical axis names."""
    rules = rules or DEFAULT_RULES
    names = set(axis_sizes(mesh))
    out = []
    for ax in logical:
        cand = tuple(a for a in rules.get(ax, ()) if a in names)
        out.append(cand if len(cand) > 1 else (cand[0] if cand else None))
    return tuple(out)


def placements_for(spec: Sequence, mesh) -> tuple:
    """DTensor placements of a partition spec: for each mesh dim,
    ``Shard(d)`` where tensor dim d's entry names it, else ``Replicate()``.
    A dim split over several mesh axes is split over them major to minor,
    as JAX splits it, only when they come in mesh order (DTensor shards
    in that order); else ``ValueError``."""
    order = list(axis_sizes(mesh))
    owner = {}
    for d, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        idx = [order.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d} splits over {axes}, not "
                             f"in the mesh's order {order}")
        for a in axes:
            if a in owner:
                raise ValueError(f"spec {spec}: mesh axis {a} used twice")
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in order)


def sharding_for(logical, mesh, rules=None) -> NamedSharding:
    return NamedSharding(mesh, placements_for(spec_for(logical, mesh, rules),
                                              mesh))


def constrain(x, mesh, *logical, rules=None):
    """``with_sharding_constraint`` by logical axes: ``x`` (a DTensor)
    redistributed to them; ``x`` itself where ``mesh`` is None. Never
    changes a value."""
    if mesh is None:
        return x
    if not isinstance(x, DTensor):
        raise TypeError("constrain on a mesh takes a DTensor")
    # redistributed even where it is laid out so already: the backward
    # then hands the gradient back in x's layout
    return x.redistribute(mesh, placements_for(spec_for(logical, mesh, rules),
                                               mesh))


def place(x: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """A full tensor, the same on every rank, split by ``sharding`` (a
    DTensor: redistributed to it)."""
    if isinstance(x, DTensor):
        return x.redistribute(sharding.mesh, sharding.placements)
    return distribute_tensor(x, sharding.mesh, sharding.placements)


def settle(x: DTensor) -> DTensor:
    """``x`` with every pending sum (``Partial``) reduced (``Replicate``).
    A cast of a partial sum would round each rank's part before the sum
    (a bf16 cache from fp32 partials differs by a few ulps); after
    ``settle`` it rounds the whole value."""
    if not any(isinstance(p, Partial) for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if isinstance(p, Partial) else p for p in x.placements])


def full(x):
    """The whole value of a DTensor as a plain tensor (``x`` itself when
    it is plain)."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def replicate(x: torch.Tensor, mesh) -> DTensor:
    """A tensor made alike on every rank (a position table) as a
    replicated DTensor, without a copy or a collective."""
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def local_map(fn, mesh, in_placements, out_placements):
    """``shard_map``: ``fn`` of local shards, applied to DTensors. Each
    DTensor argument is redistributed to its entry of ``in_placements``
    (``None``: passed as it is) and handed to ``fn`` as its local shard;
    ``fn``'s tensor outputs become DTensors with ``out_placements``.
    Differentiable: an input's gradient comes back sharded where the input
    is, and, where the input is replicated over a mesh dim that another
    input is split over (a weight beside batch-sharded activations), as
    each rank's share of a sum (``Partial``): the ranks' local gradients
    differ there, and the whole gradient is their sum."""
    from torch.distributed.tensor.placement_types import Placement
    if all(isinstance(p, Placement) for p in out_placements):
        out_placements = list(out_placements)       # one output
    split = {i for pl in in_placements if pl is not None
             for i, p in enumerate(pl) if isinstance(p, Shard)}
    grads = tuple(None if pl is None else tuple(
        Partial() if isinstance(p, Replicate) and i in split else p
        for i, p in enumerate(pl)) for pl in in_placements)
    return _local_map(fn, out_placements=out_placements,
                      in_placements=in_placements, in_grad_placements=grads,
                      device_mesh=mesh, redistribute_inputs=True)


def batch_axes_for(global_batch: int, mesh) -> tuple:
    """Pick the largest prefix of (pod, data) that divides the batch.

    ``long_500k`` has batch 1 → batch is replicated and the KV sequence
    picks up the idle axes instead (see rules ``kv_seq_wide``).
    """
    sizes = axis_sizes(mesh)
    axes = []
    n = 1
    for a in ("pod", "data"):
        if a in sizes:
            sz = sizes[a]
            if global_batch % (n * sz) == 0:
                axes.append(a)
                n *= sz
    return tuple(axes)


def rules_for(mesh, global_batch: int, *, wide_kv: bool = False) -> dict:
    """Shape-aware rule table (handles batch-1 decode + multi-pod FSDP)."""
    names = axis_sizes(mesh)
    rules = dict(DEFAULT_RULES)
    rules["batch"] = batch_axes_for(global_batch, mesh)
    if "pod" in names:
        rules["embed"] = ("pod", "data")  # FSDP over both replica axes
    if wide_kv and not rules["batch"]:
        rules["kv_seq"] = tuple(a for a in ("pod", "data", "model")
                                if a in names)
    return rules
