"""The port's attention kernels on the CPU: their plain versions (and the
port's chunked flash attention) against the Pallas kernels in interpret
mode, on the same numpy inputs. The CUDA kernels themselves are held
against their plain versions on a card by tests/test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as pk_flash
from repro.kernels.paged_attn.ops import paged_attention as pk_paged
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.paged_attn import kernel as paged_kernel
from repro_torch.kernels.paged_attn import ops as paged_ops
from repro_torch.models import attention as tattn

# tests/test_kernels.py: TOLS
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}
FLASH_SHAPES = [            # tests/test_kernels.py: test_flash_kernel_sweep
    (2, 256, 4, 2, 64, 0, 64),
    (1, 512, 4, 1, 128, 0, 128),
    (2, 128, 8, 8, 32, 64, 64),
    (1, 256, 2, 2, 64, 128, 128),
]
PAGED_SHAPES = [            # tests/test_kernels.py: test_paged_attention_sweep
    (2, 4, 2, 64, 32, 4),
    (3, 8, 2, 64, 16, 8),
    (1, 4, 4, 128, 64, 2),
    (2, 48, 1, 128, 16, 3),     # granite-34b's G 48 over one KV head
    (2, 14, 2, 128, 16, 3),     # yi-34b's G 7
]


def _both(a, dtype):
    """numpy fp32 -> (jax array, torch tensor) of ``dtype``, equal values."""
    return (jnp.asarray(a).astype(dtype),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _flash_inputs(B, S, H, KH, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd), np.float32),
            rng.standard_normal((B, S, KH, hd), np.float32),
            rng.standard_normal((B, S, KH, hd), np.float32))


def _paged_inputs(B, H, KH, hd, page, nblk, seed=3):
    rng = np.random.default_rng(seed)
    npool = nblk * B + 4
    q = rng.standard_normal((B, H, hd), np.float32)
    kp = rng.standard_normal((npool, page, KH, hd), np.float32)
    vp = rng.standard_normal((npool, page, KH, hd), np.float32)
    table = rng.permutation(npool)[:B * nblk].reshape(B, nblk) \
        .astype(np.int32)
    lens = rng.integers(1, nblk * page + 1, B).astype(np.int32)
    return q, kp, vp, table, lens


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KH,hd,win,bq", FLASH_SHAPES)
def test_flash_plain_matches_pallas(dtype, B, S, H, KH, hd, win, bq):
    qkv = _flash_inputs(B, S, H, KH, hd)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in qkv)
    ref = _np(pk_flash(jq, jk, jv, window=win, block_q=bq, block_k=bq,
                       interpret=True))
    tol = TOLS[dtype]
    outs = {
        "plain": flash_ops.flash_attention(tq, tk, tv, window=win),
        "triangular": tattn.flash_attention(tq, tk, tv, window=win,
                                            q_chunk=bq),
        "rect": tattn.flash_attention(tq, tk, tv, window=win, q_chunk=bq,
                                      schedule="rect"),
    }
    for name, out in outs.items():
        assert out.dtype == tq.dtype and out.shape == tq.shape, name
        np.testing.assert_allclose(_np(out), ref, atol=tol, rtol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("B,H,KH,hd,page,nblk", PAGED_SHAPES)
def test_paged_plain_matches_pallas(B, H, KH, hd, page, nblk):
    q, kp, vp, table, lens = _paged_inputs(B, H, KH, hd, page, nblk)
    ref = pk_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                   jnp.asarray(table), jnp.asarray(lens), interpret=True)
    T = torch.from_numpy
    out = paged_ops.paged_attention(T(q), T(kp), T(vp), T(table), T(lens))
    np.testing.assert_allclose(_np(out), _np(ref), atol=3e-5, rtol=3e-5)


def test_paged_zero_length_row_is_mean_of_v():
    """A row with every position masked gives the mean of V over the
    table's slots (ROADMAP Queue 3), in the plain version and in Pallas."""
    B, H, KH, hd, page, nblk = 2, 4, 2, 64, 16, 3
    q, kp, vp, table, _ = _paged_inputs(B, H, KH, hd, page, nblk, seed=4)
    lens = np.asarray([0, 20], np.int32)
    T = torch.from_numpy
    out = _np(paged_ops.paged_attention(T(q), T(kp), T(vp), T(table),
                                        T(lens)))
    mean_v = vp[table[0]].reshape(nblk * page, KH, hd).mean(0)   # (KH, hd)
    expect = np.repeat(mean_v, H // KH, axis=0)
    np.testing.assert_allclose(out[0], expect, atol=3e-5, rtol=3e-5)
    assert np.isfinite(out).all()
    pallas = _np(pk_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                          jnp.asarray(table), jnp.asarray(lens),
                          interpret=True))
    np.testing.assert_allclose(out, pallas, atol=3e-5, rtol=3e-5)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper launches or raises; the CPU plain path is chosen
    by the ops, from the tensor's device, never by the wrapper."""
    counts = (flash_kernel.flash_attention_fwd.launches,
              paged_kernel.paged_attention.launches)
    q, k, v = (torch.from_numpy(a) for a in _flash_inputs(1, 64, 2, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        flash_kernel.flash_attention_fwd(q, k, v)
    pq, kp, vp, table, lens = (torch.from_numpy(a) for a in
                               _paged_inputs(1, 2, 2, 64, 16, 2))
    with pytest.raises(ValueError, match="CUDA"):
        paged_kernel.paged_attention(pq, kp, vp, table, lens)
    flash_ops.flash_attention(q, k, v)              # plain version, no launch
    paged_ops.paged_attention(pq, kp, vp, table, lens)
    assert (flash_kernel.flash_attention_fwd.launches,
            paged_kernel.paged_attention.launches) == counts
