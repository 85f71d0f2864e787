"""Paged-KV decode attention — the hand-written CUDA kernel's wrapper.

The kernel is ``csrc/paged_attn.cu`` (it replaces the Pallas TPU kernel
``repro/kernels/paged_attn/kernel.py:paged_attention``); its header says
what bounds it and how it is laid out. This wrapper checks its inputs,
allocates the output, launches on the current stream and counts launches
in ``paged_attention.launches``. It takes CUDA tensors only; the plain
version is ``ref.paged_attention_ref``, and ``ref.paged_attention_split_ref``
repeats the kernel's split-and-merge in PyTorch. ``plan`` reports the
decomposition a call launches, row tiles included: any G = H / KH is
taken, in tiles of at most 1024 / hd query rows a CTA.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

SOURCE = "paged_attn"
_SYMBOLS = {torch.bfloat16: "paged_attn_bf16", torch.float32: "paged_attn_f32"}
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
             + [ctypes.c_int64] * 11
             + [ctypes.c_float, ctypes.c_void_p])


def paged_attention(q, k_pages, v_pages, page_table, lengths, *,
                    scale: float | None = None):
    """q: (B, H, hd); pools: (n_pages, page_sz, KH, hd), same dtype as q
    (bf16 or fp32), any strides with a contiguous head dim;
    page_table: (B, nblk) int32; lengths: (B,) int32. Returns (B, H, hd)
    in q's dtype."""
    B, H, hd = q.shape
    n_pages, page_sz, KH, hd_k = k_pages.shape
    for t in (q, k_pages, v_pages, page_table, lengths):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("paged_attention launches a CUDA kernel: every "
                             "input must be on one CUDA device, got "
                             + str(t.device))
    if q.dtype not in _SYMBOLS or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged kernel takes bf16 or fp32 q and pools of one "
                        f"dtype, got {q.dtype}/{k_pages.dtype}/"
                        f"{v_pages.dtype}")
    if v_pages.shape != k_pages.shape or hd_k != hd or H % KH:
        raise ValueError(f"bad shapes q{tuple(q.shape)} "
                         f"pools{tuple(k_pages.shape)}")
    if q.stride(-1) != 1 or k_pages.stride(-1) != 1 \
            or v_pages.stride(-1) != 1:
        raise ValueError("paged kernel needs a contiguous head dim")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("page_table and lengths must be int32")
    if page_table.ndim != 2 or page_table.shape[0] != B \
            or page_table.shape[1] < 1 or page_table.stride(1) != 1 \
            or tuple(lengths.shape) != (B,) or not lengths.is_contiguous():
        raise ValueError(f"bad page_table{tuple(page_table.shape)} / "
                         f"lengths{tuple(lengths.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    nblk = page_table.shape[1]
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    symbol = _SYMBOLS[q.dtype]
    fn = _build.bind(SOURCE, symbol, _ARGTYPES)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             B, H, KH, hd, page_sz, nblk,
             q.stride(0), q.stride(1),
             k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
             v_pages.stride(0), v_pages.stride(1), v_pages.stride(2),
             page_table.stride(0), out.stride(0), out.stride(1),
             float(scale), _build.stream_handle(q.device))
    _build.check(SOURCE, symbol, err)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def plan(nblk: int, page_sz: int, G: int, hd: int, dtype) -> dict:
    """The kernel's decomposition for these shapes (it depends on shapes
    only): CTAs a cluster, pages a CTA, pages a shared-memory stage,
    shared-memory bytes a CTA, how many such clusters the card holds at
    once, row tiles a KV head and query rows a tile. Builds the kernel if
    needed."""
    fn = _build.bind(SOURCE, "paged_attn_plan", [ctypes.c_int] * 5
                     + [ctypes.c_void_p])
    out = (ctypes.c_int * 7)()
    err = fn(nblk, page_sz, G, hd, int(dtype == torch.bfloat16),
             ctypes.cast(out, ctypes.c_void_p))
    _build.check(SOURCE, "paged_attn_plan", err)
    return dict(zip(("n_split", "pages_per_split", "pages_per_stage",
                     "smem_bytes", "max_active_clusters", "row_tiles",
                     "rows_per_tile"), out))

