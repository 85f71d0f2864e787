"""The plain split-merge version of the paged decode kernel
(``paged_attention_split_ref``, the CUDA kernel's decomposition in PyTorch,
its row tiles included) against the Pallas ``paged_attention`` in
interpret mode and against ``paged_attention_ref``, on the same numpy
inputs."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attn.ops import paged_attention as pk_paged
from repro_torch.kernels.paged_attn.ref import (paged_attention_ref,
                                                paged_attention_split_ref)

# 3e-5 as tests/test_torch_kernels.py holds paged fp32; bf16 as TOLS
TOLS = {"float32": 3e-5, "bfloat16": 2e-2}
B, KH, HD, PAGE, NBLK = 3, 2, 32, 8, 5
N_SPLITS = (1, 2, 3, NBLK + 2)               # the last: more splits than pages


def _inputs(G, seed):
    rng = np.random.default_rng(seed)
    npool = NBLK * B + 3
    q = rng.standard_normal((B, G * KH, HD), np.float32)
    kp = rng.standard_normal((npool, PAGE, KH, HD), np.float32)
    vp = rng.standard_normal((npool, PAGE, KH, HD), np.float32)
    table = rng.permutation(npool)[:B * NBLK].reshape(B, NBLK) \
        .astype(np.int32)
    lens = rng.integers(1, NBLK * PAGE + 1, B).astype(np.int32)
    return q, kp, vp, table, lens


def _round(a, dtype):
    """numpy values as ``dtype`` holds them (bf16 rounding), in fp32."""
    return torch.from_numpy(a).to(getattr(torch, dtype)).float().numpy()


@functools.lru_cache(maxsize=None)
def _case(G, dtype, lens_key):
    """Inputs (rounded to ``dtype``) and the Pallas output, fp32 numpy."""
    q, kp, vp, table, lens = _inputs(G, seed=10 + G)
    if lens_key is not None:
        lens = np.asarray(lens_key, np.int32)
    q, kp, vp = (_round(a, dtype) for a in (q, kp, vp))
    ref = pk_paged(*(jnp.asarray(a).astype(dtype) for a in (q, kp, vp)),
                   jnp.asarray(table), jnp.asarray(lens), interpret=True)
    return (q, kp, vp, table, lens), np.asarray(ref.astype(jnp.float32))


def _torch(args, dtype):
    q, kp, vp, table, lens = args
    t = getattr(torch, dtype)
    return (torch.from_numpy(q).to(t), torch.from_numpy(kp).to(t),
            torch.from_numpy(vp).to(t), torch.from_numpy(table),
            torch.from_numpy(lens))


def _check(n_split, G, dtype, lens=None):
    args, pallas = _case(G, dtype, lens)
    targs = _torch(args, dtype)
    out = paged_attention_split_ref(*targs, n_split=n_split)
    assert out.dtype == targs[0].dtype and out.shape == targs[0].shape
    out = out.float().numpy()
    assert np.isfinite(out).all()
    tol = TOLS[dtype]
    np.testing.assert_allclose(out, pallas, atol=tol, rtol=tol,
                               err_msg="vs Pallas")
    plain = paged_attention_ref(*targs).float().numpy()
    np.testing.assert_allclose(out, plain, atol=tol, rtol=tol,
                               err_msg="vs paged_attention_ref")
    return out, args


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("n_split", N_SPLITS)
def test_split_ref_matches_pallas_and_plain(n_split, G, dtype):
    _check(n_split, G, dtype)


@pytest.mark.parametrize("n_split", N_SPLITS)
def test_split_ref_zero_length_row_is_mean_of_v(n_split):
    """Every position masked: each split weighs 1 and the row is the mean
    of V over the table's slots."""
    G = 2
    out, (q, kp, vp, table, lens) = _check(n_split, G, "float32",
                                           lens=(0, 17, NBLK * PAGE))
    mean_v = vp[table[0]].reshape(NBLK * PAGE, KH, HD).mean(0)
    np.testing.assert_allclose(out[0], np.repeat(mean_v, G, axis=0),
                               atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("n_split", N_SPLITS)
def test_split_ref_masks_whole_splits(n_split):
    """Lengths that leave whole splits (and, at n_split 3, the last split's
    second page) with no valid position: they weigh exactly 0."""
    _check(n_split, 2, "float32", lens=(1, PAGE + 3, 2 * PAGE))
    _check(n_split, 4, "bfloat16", lens=(3, PAGE, PAGE + 1))


def test_split_ref_matches_plain_at_decode_lengths():
    """The serving loop's split (34 pages -> 7 splits of 5) at the lengths
    a decode run reads, against the plain version only (no Pallas)."""
    rng = np.random.default_rng(2)
    nblk, page, kh, hd = 34, 16, 2, 16
    q = torch.from_numpy(rng.standard_normal((2, kh, hd), np.float32))
    kp = torch.from_numpy(rng.standard_normal((2 * nblk, page, kh, hd),
                                              np.float32))
    vp = torch.from_numpy(rng.standard_normal((2 * nblk, page, kh, hd),
                                              np.float32))
    table = torch.arange(2 * nblk, dtype=torch.int32).view(2, nblk)
    for length in (513, 528, 529, 543, 544):
        lens = torch.tensor([length, length - 17], dtype=torch.int32)
        torch.testing.assert_close(
            paged_attention_split_ref(q, kp, vp, table, lens, n_split=7),
            paged_attention_ref(q, kp, vp, table, lens),
            atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("R", [6, 1, 10, 48])
def test_row_split_ref_matches_plain_and_pallas_at_granite_g(R):
    """granite-34b's 48 query rows over one KV head at hd 128 in R row
    tiles with a page split: 6 of 8 (the kernel's: 1024 // hd rows a
    tile), 1 of 48, 10 of 5 with the last of 3, 48 of 1; against the
    plain version (to summation order) and the Pallas kernel in
    interpret mode."""
    rng = np.random.default_rng(21)
    B, G, hd, page, nblk = 2, 48, 128, 16, 3
    npool = B * nblk + 2
    q = rng.standard_normal((B, G, hd), np.float32)
    kp = rng.standard_normal((npool, page, 1, hd), np.float32)
    vp = rng.standard_normal((npool, page, 1, hd), np.float32)
    table = rng.permutation(npool)[:B * nblk].reshape(B, nblk) \
        .astype(np.int32)
    lens = np.asarray([nblk * page - 5, 0], np.int32)   # and a zero length
    T = torch.from_numpy
    out = paged_attention_split_ref(T(q), T(kp), T(vp), T(table), T(lens),
                                    n_split=2, row_tiles=R)
    plain = paged_attention_ref(T(q), T(kp), T(vp), T(table), T(lens))
    torch.testing.assert_close(out, plain, atol=3e-5, rtol=3e-5)
    pallas = pk_paged(*(jnp.asarray(a) for a in (q, kp, vp, table, lens)),
                      interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), atol=3e-5,
                               rtol=3e-5)
