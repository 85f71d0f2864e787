"""Explicit all-to-all schedules for MoE dispatch/combine (the port's
counterpart of ``repro.distributed.a2a``, over
``torch.distributed.all_to_all_single``).

The constraint-flip baseline (``moe.moe_ffn``) reshards the dispatch
buffers with two redistributions and lets DTensor choose the collectives.
These helpers make the shuffle EXPLICIT — the device-side mirror of the
paper's §4 data shuffle:

* ``a2a``          — one tiled all-to-all over a process group;
* ``a2a_chunked``  — the transfer split into ``n_chunks`` pieces along
  another axis, each its own all-to-all (the paper's batching guideline
  GL2 applied to the interconnect; the pieces run one after the other,
  and the result is that of one ``a2a``).

``a2a`` and ``a2a_chunked`` act on local shards (inside
``partitioning.local_map``, as JAX's run inside ``shard_map``);
``moe_dispatch_combine`` returns functions of DTensors. Each is
differentiable: the gradient of an all-to-all is the all-to-all back.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models import partitioning as part


def _a2a(x, group, split_axis, concat_axis):
    n = dist.get_world_size(group)
    xs = x.movedim(split_axis, 0)
    m = xs.shape[0] // n
    if m * n != xs.shape[0]:
        raise ValueError(f"axis {split_axis} of {tuple(x.shape)} does not "
                         f"split into {n} pieces")
    inp = xs.reshape((n, m) + tuple(xs.shape[1:])).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    # out[i] is rank i's piece: back to x's layout, then the pieces joined
    # along concat_axis in rank order
    out = out.movedim(1, split_axis + 1).movedim(0, concat_axis)
    shape = list(out.shape)
    shape[concat_axis:concat_axis + 2] = [n * shape[concat_axis + 1]]
    return out.reshape(shape)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, concat_axis, split_axis)
        return _a2a(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g.contiguous(), *ctx.args), None, None, None


def a2a(x, group, *, split_axis: int, concat_axis: int):
    """Tiled all-to-all (``jax.lax.all_to_all(tiled=True)``): ``x``'s
    ``split_axis`` is cut into one piece a rank of ``group``, piece i goes
    to rank i, and what arrives is joined along ``concat_axis`` in rank
    order."""
    return _AllToAll.apply(x, group, split_axis, concat_axis)


def a2a_chunked(x, group, *, split_axis: int, concat_axis: int,
                n_chunks: int, chunk_axis: int):
    """All-to-all in ``n_chunks`` pieces along ``chunk_axis``."""
    if n_chunks <= 1:
        return a2a(x, group, split_axis=split_axis, concat_axis=concat_axis)
    parts = torch.chunk(x, n_chunks, dim=chunk_axis)
    return torch.cat([a2a(p, group, split_axis=split_axis,
                          concat_axis=concat_axis) for p in parts],
                     dim=chunk_axis)


def moe_dispatch_combine(mesh, batch_axes, *, n_chunks: int = 1):
    """Returns (dispatch, combine) callables on DTensors shaped
    (B, G, Ee, C, D): dispatch takes G sharded over 'model' (group-local
    buffers) to Ee sharded over 'model' (expert-local buffers), combine
    takes them back, each by an explicit all-to-all over the mesh's
    'model' group in place of a redistribution."""
    b = tuple(batch_axes) or None
    g_pl = part.placements_for((b, "model", None, None, None), mesh)
    e_pl = part.placements_for((b, None, "model", None, None), mesh)
    group = mesh.get_group("model")

    def dispatch_local(x):    # local: (B_l, G/n, Ee, C, D)
        return a2a_chunked(x, group, split_axis=2, concat_axis=1,
                           n_chunks=n_chunks, chunk_axis=3)

    def combine_local(y):     # local: (B_l, G, Ee/n, C, D)
        return a2a_chunked(y, group, split_axis=1, concat_axis=2,
                           n_chunks=n_chunks, chunk_axis=3)

    return (part.local_map(dispatch_local, mesh, (g_pl,), e_pl),
            part.local_map(combine_local, mesh, (e_pl,), g_pl))
