"""What a traced step costs one device: the dry run's counters (the
port's counterpart of ``repro/roofline/hlo_cost.py``, which reads them
from compiled HLO; the port has no HLO and counts the operators the step
dispatches on this rank instead).

``StepCounter`` is a ``TorchDispatchMode`` run around a step on fake
tensors (``FakeTensorMode``) and DTensors over a fake process group. It
lets DTensor turn each of its operators into the operators on this rank's
local shards and counts those, so every count is per device (the
operators DTensor's sharding propagation runs at the global shapes, to
learn an output's shape, are not counted):

* **FLOPs**: each operator's formula in ``FlopCounterMode``'s registry
  (the matrix products: mm, bmm, addmm, baddbmm, convolutions, SDPA), the
  kernel ops by theirs (``roofline.work``, registered with the ops);
  elementwise FLOPs are not counted, as ``hlo_cost`` counts only dots.
* **HBM bytes** (``BYTES_RULE``): every operator that moves data is
  charged its tensor operands read once and its results written once;
  views and metadata (``view``, ``as_strided``, ``t``, ``expand``,
  ``detach``, ``alias``, ...; any operator whose result aliases an
  operand) and allocations are free, as ``_FREE_OPS`` is in ``hlo_cost``;
  a gather or an index reads only what it writes (2 x its result); an
  in-place operator writes the operand it returns; the kernel ops are
  charged ``roofline.work``'s bytes. Eager torch does not fuse, so this is
  what the port moves, not what a fusing compiler would.
* **Collectives**: one record per collective operator CommDebugMode
  counts (``_c10d_functional``, ``c10d``, DTensor's
  ``shard_dim_alltoall``), with its kind (the JAX package's names), the bytes of its
  result (a reduce-scatter's and an all-gather's result, as in
  ``hlo_cost``), its group's size and whether the group crosses a node
  (``launch.mesh.crosses_nodes``).
* **Peak memory**: the bytes of live storages, from the tensors alive
  when the counter starts (``hold``: parameters, optimizer state, batch,
  cache) and every storage an operator allocates, released when its last
  tensor is freed (a weak reference to the storage); ``peak_bytes`` the
  largest sum seen.
"""

from __future__ import annotations

import sys
import weakref
from collections import defaultdict

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.launch.mesh import crosses_nodes
from repro_torch.roofline import work

BYTES_RULE = ("each operator on this rank's shards: tensor operands read "
              "once, results written once; views, metadata and "
              "allocations free; gathers and indexing 2 x their result; "
              "in-place operators write the operand they return; kernel "
              "ops by roofline/work.py; no fusion (eager torch's traffic, "
              "not a fusing compiler's)")

# data-free operators with no aliasing result
_FREE = {"empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "device", "layout", "dim", "sym_size",
         "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
         "_local_scalar_dense", "lift_fresh", "_to_copy_noop"}
# operators that read what they write: 2 x the result
_GATHERS = {"index", "index_select", "gather", "embedding", "take",
            "take_along_dim"}


def _collectives() -> set:
    """The collective operators CommDebugMode counts (its registry: the
    functional collectives, DTensor's ``shard_dim_alltoall`` on CUDA
    meshes, the ``c10d`` ops), so the two counts agree by construction."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.debug._comm_mode import c10d_collective_ops
    return set(CommDebugMode().comm_registry) | set(c10d_collective_ops)


def _kind(name: str) -> str:
    """A collective's kind, the JAX package's name for it."""
    if "reduce_scatter" in name or name == "scatter_":
        return "reduce-scatter"
    if "all_reduce" in name or "allreduce" in name or name == "reduce_":
        return "all-reduce"
    if "alltoall" in name or "all_to_all" in name:
        return "all-to-all"
    if "gather" in name:
        return "all-gather"
    return "collective-permute"       # a broadcast: its bytes once a rank


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _in_sharding_prop() -> bool:
    """Whether DTensor's sharding propagation is on the stack: it runs an
    operator on fake tensors of the global shapes to learn its output's
    shape, which is no rank's work and is not counted."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


def _group_of(func, args):
    """(size, ranks) of a collective's group, from its group name (the
    functional collectives) or its process group (``c10d``)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    pg = None
    for a in args:
        if isinstance(a, str):
            try:
                pg = _resolve_process_group(a)
                break
            except Exception:       # not a group name (a reduce op)
                continue
        if isinstance(a, dist.ProcessGroup):
            pg = a
            break
    if pg is None:
        return 1, []
    ranks = dist.get_process_group_ranks(pg)
    return len(ranks), ranks


class StepCounter(TorchDispatchMode):
    """FLOPs, HBM bytes, collective records and peak live bytes of what
    runs under it on this rank (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.records: list = []
        self.by_op = defaultdict(lambda: [0, 0, 0])    # calls, flops, bytes
        self.live = 0
        self.peak = 0
        self._held = {}
        self._collectives = _collectives()
        self._live_by = defaultdict(int)    # live bytes by allocating op
        self.peak_by: dict = {}             # the same at the peak

    # --- live storages ----------------------------------------------------
    def _track(self, t, by="inputs"):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held:
            return
        n = st.nbytes()
        self._held[key] = weakref.finalize(st, self._release, key, n, by)
        self.live += n
        self._live_by[by] += n
        if self.live > self.peak:
            self.peak = self.live
            self.peak_by = dict(self._live_by)

    def _release(self, key, n, by):
        if self._held.pop(key, None) is not None:
            self.live -= n
            self._live_by[by] -= n

    def hold(self, tree, by="inputs") -> int:
        """Counts the storages of ``tree``'s tensors (DTensors: their local
        shards) as live from now on, under ``by``; returns their bytes."""
        before = self.live
        for t in _tensors(tree):
            self._track(t._local_tensor if isinstance(t, DTensor) else t,
                        by)
        return self.live - before

    def peak_holders(self, top: int = 8) -> dict:
        """The live bytes at the peak by the operator that allocated them
        (inputs by the name they were held under), the largest ``top``."""
        return dict(sorted(((k, v) for k, v in self.peak_by.items() if v),
                           key=lambda kv: -kv[1])[:top])

    # --- dispatch ---------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # count its local operators
        out = func(*args, **kwargs)
        if _in_sharding_prop():
            return out
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        packet = func._overloadpacket
        flops = 0
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        if ns == "repro_torch":
            n_bytes = work.op_work(name, args)[0]
        elif packet in self._collectives:
            kind = _kind(name)
            group, ranks = _group_of(func, list(args) +
                                     list(kwargs.values()))
            res = outs[0] if outs else ins[0]
            if kind == "reduce-scatter" or kind == "all-gather":
                size = sum(_nbytes(t) for t in outs) if outs else \
                    _nbytes(ins[-1])
            else:
                size = sum(_nbytes(t) for t in ins[:1]) or _nbytes(res)
            self.records.append({"kind": kind, "bytes": size,
                                 "group": group,
                                 "internode": crosses_nodes(ranks)})
            n_bytes = sum(_nbytes(t) for t in ins) + \
                sum(_nbytes(t) for t in outs
                    if not any(t is i for i in ins))
        elif name in _FREE or _is_view(func) or name == "wait_tensor":
            n_bytes = 0
        elif name in _GATHERS:
            n_bytes = 2 * sum(_nbytes(t) for t in outs)
        else:
            n_bytes = sum(_nbytes(t) for t in ins) + \
                sum(_nbytes(t) for t in outs
                    if not any(t is i for i in ins))
        self.flops += flops
        self.bytes += n_bytes
        rec = self.by_op[f"{ns}.{name}"]
        rec[0] += 1
        rec[1] += flops
        rec[2] += n_bytes
        for t in outs:
            if not any(t is i for i in ins):
                self._track(t, f"{ns}.{name}")

    def kernel_ops(self) -> dict:
        """The kernel ops' calls, FLOPs and bytes, by op."""
        return {k.split(".", 1)[1]: {"calls": v[0], "flops": v[1],
                                     "bytes": v[2]}
                for k, v in self.by_op.items() if k.startswith("repro_torch")}
