"""Carry weights and caches across from the JAX package through numpy.

The caller turns each leaf of a ``repro`` tree into a numpy array
(``np.asarray``); these functions turn such a tree into the port's
tensors, so the port itself never sees JAX. bf16 leaves (numpy dtype
name ``bfloat16``) go through ``uint16`` views, bit for bit, as the KV
pager packs pages (``repro/serve/kv_paging.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import lm
from repro_torch.models.layers import ParamDef


def _tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _convert(tree, defs, device, path=""):
    if isinstance(defs, ParamDef):
        t = _tensor_from_numpy(tree, device)
        if tuple(t.shape) != tuple(defs.shape):
            raise ValueError(f"{path}: shape {tuple(t.shape)} != "
                             f"{tuple(defs.shape)}")
        return t
    if set(tree) != set(defs):
        raise ValueError(f"{path or 'tree'}: keys {sorted(tree)} != "
                         f"{sorted(defs)}")
    return {k: _convert(tree[k], defs[k], device, f"{path}/{k}")
            for k in defs}


def params_from_numpy(cfg, tree: dict, *, device="cuda") -> dict:
    """A ``repro.models.lm.init_params`` tree with numpy leaves -> the
    port's params (same keys and shapes, checked against param_defs)."""
    return _convert(tree, lm.param_defs(cfg), resolve_device(device))


def cache_from_numpy(cfg, tree: dict, *, device="cuda") -> dict:
    """A ``repro.models.lm`` decode cache with numpy leaves -> the port's
    cache (the keys of ``lm.cache_spec_defs``: "k"/"v" (G, B, Smax, KH, hd)
    bf16 where the family attends, MLA's "ckv"/"kr" (L, B, Smax, ·), "ssm"
    and "conv_x/b/c" where it has Mamba2 layers). Batch and length are read
    from the leaves present."""
    seq = next((n for n in ("k", "ckv") if n in tree), None)
    if seq is not None:
        batch, length = np.asarray(tree[seq]).shape[1:3]
    else:                      # attention-free: no sequence axis
        batch, length = np.asarray(tree["ssm"]).shape[1], 0
    defs = lm.cache_spec_defs(cfg, length, batch)
    return _convert(tree, defs, resolve_device(device))
