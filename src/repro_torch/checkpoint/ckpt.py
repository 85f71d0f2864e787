"""Group-commit checkpointing over the ring (the port's counterpart of
``repro.checkpoint.ckpt``: paper §3.6 durable writes + GL3 applied to
fault tolerance), with the same on-disk format, so a checkpoint written
by either package loads in the other.

Layout per step:  <dir>/step_<N>/
    data.bin       every leaf, concatenated (offset table in manifest)
    manifest.json  leaf offsets, shapes and dtypes — written AFTER the
                   data file is fsync'd, then atomically renamed: a
                   checkpoint exists iff its manifest exists (group commit)

All data writes are WRITE SQEs batched into one submission; durability is
ONE linked FSYNC per checkpoint — not per tensor (the paper's group-commit
guideline). Leaves are listed in ``jax.tree_util.tree_flatten`` order
(``repro_torch.tree``); bf16 leaves are stored as their raw 16 bits under
the dtype name ``bfloat16``, as the JAX package stores them.

Restore reads the leaves into host memory and places each on the device
of the matching leaf of the tree it is given, or, given ``shardings``,
splits it onto any mesh (elastic: not necessarily the one that saved).

On a mesh a DTensor leaf is saved as its whole value (``full_tensor``, a
collective every rank takes part in); under ``torch.distributed`` only
global rank 0 writes, and every rank returns once the checkpoint is
published.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import FileBackend, IoUring, SetupFlags, Timeline
from repro_torch.core.ring import prep_fsync, prep_write
from repro_torch.models import partitioning as part
from repro_torch.tree import tree_flatten, tree_unflatten


def _to_numpy(leaf):
    """(array of the leaf's bytes, dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = part.full(leaf.detach()).cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def _from_numpy(a, name, like):
    t = torch.from_numpy(a.copy())
    if name == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(like.device) if isinstance(like, torch.Tensor) else t


def save_checkpoint(ckpt_dir: str, step: int, tree, *, keep: int = 3,
                    timeline: Optional[Timeline] = None) -> str:
    final = os.path.join(ckpt_dir, f"step_{step}")
    leaves, _ = tree_flatten(tree)
    arrays, names = zip(*(_to_numpy(x) for x in leaves)) if leaves \
        else ((), ())
    if dist.is_initialized():
        if dist.get_rank() == 0:
            _write(ckpt_dir, step, arrays, names, keep, timeline)
        dist.barrier()
    else:
        _write(ckpt_dir, step, arrays, names, keep, timeline)
    return final


def _write(ckpt_dir, step, arrays, names, keep, timeline):
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    data_path = os.path.join(tmp, "data.bin")
    offsets, off = [], 0
    for a in arrays:
        offsets.append(off)
        off += a.nbytes

    with open(data_path, "wb") as f:
        f.truncate(off)

    tl = timeline or Timeline()
    ring = IoUring(tl, sq_depth=max(64, len(arrays) + 2),
                   setup=SetupFlags.DEFER_TASKRUN | SetupFlags.SINGLE_ISSUER)
    fb = FileBackend(data_path)
    ring.register_device(11, fb)
    # batched writes ...
    for a, o in zip(arrays, offsets):
        sqe = ring.get_sqe()
        while sqe is None:
            ring.submit()
            sqe = ring.get_sqe()
        prep_write(sqe, 11, memoryview(a.tobytes()), o, a.nbytes,
                   user_data=o)
    # ... + ONE linked fsync: the group commit
    last = ring.get_sqe()
    prep_fsync(last, 11, user_data=1)
    n = len(arrays) + 1
    ring.submit()
    ring.wait_cqes(n)
    fb.close()

    manifest = {
        "step": step,
        "leaves": [{"offset": o, "shape": list(a.shape), "dtype": name}
                   for a, o, name in zip(arrays, offsets, names)],
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    shutil.rmtree(final, ignore_errors=True)
    os.rename(tmp, final)                      # atomic publish

    # retention
    steps = sorted(latest_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"),
                      ignore_errors=True)


def latest_steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, name, "manifest.json")):
            out.append(int(name.split("_")[1]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = latest_steps(ckpt_dir)
    return steps[-1] if steps else None


def load_checkpoint(ckpt_dir: str, step: int, like_tree, *,
                    shardings=None):
    """Restore into the structure of ``like_tree``: each leaf comes back
    with its stored dtype and shape, on the device of the matching leaf
    of ``like_tree`` (the CPU where that leaf is not a tensor), or, where
    ``shardings`` is a matching tree of ``NamedSharding``s, as a DTensor
    placed by it (elastic: the target mesh may differ from the one that
    saved)."""
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves, treedef = tree_flatten(like_tree)
    assert len(leaves) == len(manifest["leaves"]), "tree mismatch"
    data = np.memmap(os.path.join(d, "data.bin"), dtype=np.uint8, mode="r")
    sh_leaves = tree_flatten(shardings)[0] if shardings is not None \
        else [None] * len(leaves)
    out = []
    for like, meta, sh in zip(leaves, manifest["leaves"], sh_leaves):
        name = meta["dtype"]
        dt = np.dtype(np.uint16 if name == "bfloat16" else name)
        a = np.frombuffer(data, dtype=dt,
                          count=int(np.prod(meta["shape"], dtype=np.int64)),
                          offset=meta["offset"]).reshape(meta["shape"])
        t = _from_numpy(a, name, like)
        if sh is not None:
            t = part.place(t.to(sh.mesh.device_type), sh)
        out.append(t)
    return tree_unflatten(treedef, out)


class Checkpointer:
    """Every-N-steps group-commit checkpointing with retention."""

    def __init__(self, ckpt_dir: str, every: int = 50, keep: int = 3):
        self.dir = ckpt_dir
        self.every = every
        self.keep = keep

    def maybe_save(self, step: int, tree) -> Optional[str]:
        if step % self.every == 0 and step > 0:
            return save_checkpoint(self.dir, step, tree, keep=self.keep)
        return None

    def restore_or(self, like_tree, shardings=None):
        s = latest_step(self.dir)
        if s is None:
            return None, 0
        return load_checkpoint(self.dir, s, like_tree,
                               shardings=shardings), s
