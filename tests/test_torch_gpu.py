"""The port's CUDA kernels on a card, each held against its plain PyTorch
version, the smoke serving path on the card against the CPU, and the
mesh path on a one-rank NCCL mesh against the path without one. Every
test here carries the ``gpu`` marker and skips without a card; the file
imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import pathlib
import sys

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_fwd_ref,
                                                     tile_kinds)
from repro_torch.kernels.paged_attn import kernel as paged_kernel
from repro_torch.kernels.paged_attn import ops as paged_ops
from repro_torch.kernels.paged_attn.ref import paged_attention_split_ref
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import (BWD_GROUP, bwd_head_groups,
                                              bwd_tile_pairs,
                                              ssd_chunk_bwd_ref,
                                              ssd_chunk_bwd_split_ref,
                                              ssd_chunk_ref,
                                              ssd_chunk_split_ref, ssd_ref)
from repro_torch.models import attention as attn
from repro_torch.models import lm
from repro_torch.serve import ServeLoop

pytestmark = pytest.mark.gpu

TOLS = {torch.float32: 2e-5, torch.bfloat16: 2e-2}    # tests/test_kernels.py
FLASH_SHAPES = [(2, 256, 4, 2, 64, 0), (1, 512, 4, 1, 128, 0),
                (2, 128, 8, 8, 32, 64), (1, 256, 2, 2, 64, 128),
                (2, 200, 4, 2, 64, 48),                # ragged, windowed
                (2, 192, 4, 4, 80, 0), (1, 200, 4, 2, 80, 0),   # zamba2 hd
                (2, 256, 12, 2, 128, 0), (1, 200, 12, 2, 128, 0)]  # qwen2-vl
PAGED_SHAPES = [(2, 4, 2, 64, 32, 4), (3, 8, 2, 64, 16, 8),
                (1, 4, 4, 128, 64, 2),
                (2, 16, 4, 128, 64, 5),                # GQA, hd 128, pages of 64
                (4, 12, 2, 128, 16, 34),               # qwen2-vl: G 6, hd 128
                (4, 48, 1, 128, 16, 34),               # granite-34b: G 48
                (4, 56, 8, 128, 16, 34),               # yi-34b: G 7
                (4, 64, 8, 128, 16, 34)]               # deepseek-67b: G 8
# the backward: GQA, hd 32-128, a window, S = 513 and S = 130 (not a
# multiple of the 64-row tiles); lse is fp32 arithmetic in both kernels
# (the bf16 kernel keeps its max in log2 units): measured <= 9.5e-7
FLASH_BWD_SHAPES = [(2, 256, 4, 2, 64, 0), (1, 513, 4, 1, 128, 0),
                    (2, 128, 8, 8, 32, 64), (1, 200, 4, 2, 80, 48),
                    (2, 130, 4, 4, 64, 0),
                    (2, 300, 12, 2, 128, 0)]           # qwen2-vl: GQA 6:1
LSE_TOL = 1e-5
# the bf16 backward at the edges of its tiles: ragged S around 64-row q
# tiles and 128-key dK/dV CTAs, Sk != S both ways, windows 48 and 100 with
# GQA 4:1, hd 80 and 128 (B, S, Sk, H, KH, hd, window)
FLASH_BWD_EDGES = ([(2, S, S, 4, 2, 64, 0)
                    for S in (1, 63, 65, 127, 129, 255, 257, 513)]
                   + [(2, 100, 160, 4, 2, 64, 0), (2, 160, 100, 4, 2, 64, 0),
                      (1, 129, 300, 4, 4, 64, 0), (1, 300, 129, 4, 4, 64, 0),
                      (1, 300, 300, 8, 2, 64, 48),
                      (2, 257, 257, 8, 2, 64, 100),
                      (2, 257, 257, 8, 2, 80, 0), (1, 300, 300, 4, 2, 80, 48),
                      (2, 257, 257, 4, 1, 128, 0),
                      (1, 200, 130, 4, 2, 128, 100)])
# B, H, KH, hd, page, nblk: both serving shapes (34 pages of 16) and an nblk
# that is not a multiple of its split (11 pages -> 6 CTAs of 2)
PERMUTE_SHAPES = [(4, 32, 32, 64, 16, 34), (4, 32, 32, 80, 16, 34),
                  (2, 8, 2, 64, 16, 11),
                  (4, 12, 2, 128, 16, 34),             # qwen2-vl: G 6
                  (4, 48, 1, 128, 16, 34),             # granite-34b: 6 row tiles
                  (4, 56, 8, 128, 16, 34),             # yi-34b: G 7
                  (4, 64, 8, 128, 16, 34)]             # deepseek-67b: G 8
SSD_ATOL, SSD_RTOL = 2e-5, 2e-4                        # tests/test_kernels.py
SSD_SHAPES = [(2, 128, 4, 32, 16, 32), (1, 256, 8, 16, 32, 64),
              (2, 64, 2, 64, 64, 64),                  # tests/test_kernels.py
              (2, 6, 4, 16, 8, 1),                     # cl = 1 (decode)
              (1, 512, 3, 128, 128, 256),              # hp 128, two chunks
              (1, 100, 2, 16, 8, 100),                 # ragged 64-row tiles
              (1, 200, 4, 32, 16, 100),                # cl not a multiple of 16
              (4, 512, 80, 64, 64, 256),               # zamba2-2.7b prefill
              (4, 512, 24, 64, 128, 256),              # mamba2-130m prefill
              (4, 1, 80, 64, 64, 1),                   # their decode steps
              (4, 1, 24, 64, 128, 1),
              (2, 3, 2, 12, 10, 1),                    # ns % 4 != 0 at cl 1
              (1, 64, 3, 12, 20, 32)]                  # scalar-kernel shape
# the SSD backward (B, S, nh, hp, ns, cl): the smoke configs' head shape,
# and one of zamba2-2.7b's with a ragged last 64-row tile (cl 200); each
# gradient within SSD_BWD_TOL of its largest element (for dA_log, a sum
# of terms that cancel, of Σ |ddt| dt), the same fp32 arithmetic summed in
# other orders; a bf16 dx/dB/dC may be one bf16 ulp (2^-7 relative) from
# the plain one
SSD_BWD_SHAPES = [(2, 128, 4, 32, 16, 32), (1, 400, 3, 64, 64, 200)]
SSD_BWD_TOL = 1e-4
# slow decay: dt scaled by SLOW_DT makes dt·A about -0.008 a token (not
# -0.8), so exp(tot), w_j across the chunk and L between tiles two apart
# are 0.1 to 1 and an error in them shows; cl 200 and 256, zamba2-2.7b's
# and mamba2-130m's head shapes
SLOW_DT = 0.01
SSD_BWD_SLOW_SHAPES = [(1, 400, 3, 64, 64, 200), (2, 512, 3, 64, 128, 256)]
# every shape the SSD backward was checked at on the card (chip_smoke.py
# and the tests above): the smoke configs' head shape, a chunk that is not
# a multiple of 16, ragged 64-row tiles at cl 100 and 200, cl 256 at
# mamba2-130m's head shape, the hp x ns sweep of the tensor-core instance
# and the training calls of zamba2-2.7b and mamba2-130m
SSD_BWD_EVERY = ([(2, 128, 4, 32, 16, 32), (1, 200, 4, 32, 16, 100),
                  (2, 96, 3, 16, 8, 48), (1, 200, 2, 64, 64, 200),
                  (1, 400, 3, 64, 64, 200), (2, 512, 3, 64, 128, 256)]
                 + [(2, 256, 3, hp, ns, 128) for hp in (16, 32)
                    for ns in (8, 16, 32, 64, 128)]
                 + [(1, 4096, 80, 64, 64, 256), (2, 4096, 24, 64, 128, 256)])
# the tensor-core instance's head shapes: hp x ns, two chunks of 128
SSD_HEAD_SWEEP = [(hp, ns) for hp in (16, 32, 64)
                  for ns in (8, 16, 32, 64, 128)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)) \
        .to(dev, dtype)


def _paged_inputs(dev, dtype, B, H, KH, hd, page, nblk, seed=3):
    rng = np.random.default_rng(seed)
    npool = nblk * B + 4
    q = _rand(rng, (B, H, hd), dtype, dev)
    kp = _rand(rng, (npool, page, KH, hd), dtype, dev)
    vp = _rand(rng, (npool, page, KH, hd), dtype, dev)
    table = torch.from_numpy(rng.permutation(npool)[:B * nblk]
                             .reshape(B, nblk).astype(np.int32)).to(dev)
    lens = torch.from_numpy(rng.integers(0, nblk * page + 1, B)
                            .astype(np.int32)).to(dev)
    return q, kp, vp, table, lens


def _assert_close(out, ref, tol):
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KH,hd,win", FLASH_SHAPES)
def test_flash_kernel_matches_plain(cuda, dtype, B, S, H, KH, hd, win):
    rng = np.random.default_rng(0)
    q = _rand(rng, (B, S, H, hd), dtype, cuda)
    k = _rand(rng, (B, S, KH, hd), dtype, cuda)
    v = _rand(rng, (B, S, KH, hd), dtype, cuda)
    before = flash_kernel.flash_attention_fwd.launches
    out = flash_ops.flash_attention(q, k, v, window=win)
    torch.cuda.synchronize()
    assert flash_kernel.flash_attention_fwd.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    _assert_close(out, attn.reference_attention(q, k, v, window=win),
                  TOLS[dtype])


@pytest.mark.parametrize("S,Sk,hd,win", [
    (1, 1, 64, 0), (63, 63, 64, 0), (65, 65, 64, 0), (127, 127, 64, 0),
    (129, 129, 64, 0), (513, 513, 64, 0),          # ragged q and key tiles
    (100, 160, 64, 0), (160, 100, 64, 0), (129, 70, 128, 0),   # Sk != S
    (200, 200, 80, 48), (130, 130, 32, 20)])       # windows, hd 80 and 32
def test_flash_bf16_kernel_at_tile_edges(cuda, S, Sk, hd, win):
    """The TMA + wgmma kernel where q rows, keys or the window end inside
    a 64-row q tile or a 64-key tile."""
    rng = np.random.default_rng(2)
    q = _rand(rng, (2, S, 4, hd), torch.bfloat16, cuda)
    k = _rand(rng, (2, Sk, 2, hd), torch.bfloat16, cuda)
    v = _rand(rng, (2, Sk, 2, hd), torch.bfloat16, cuda)
    out = flash_kernel.flash_attention_fwd(q, k, v, window=win)
    _assert_close(out, attn.reference_attention(q, k, v, window=win),
                  TOLS[torch.bfloat16])


@pytest.mark.parametrize("dtype,pad", [(torch.float32, 4),
                                       (torch.bfloat16, 8)])
def test_flash_kernel_reads_strided_inputs(cuda, dtype, pad):
    """q/k/v that are views into wider rows are read through their strides
    (bf16 rows must stay 16-byte aligned; fp32 takes any row stride)."""
    rng = np.random.default_rng(1)
    B, S, H, KH, hd = 2, 96, 4, 2, 64
    q = _rand(rng, (B, S, H, hd + pad), dtype, cuda)[..., :hd]
    k = _rand(rng, (B, S, KH, hd + pad), dtype, cuda)[..., :hd]
    v = _rand(rng, (B, S, KH, hd + pad), dtype, cuda)[..., :hd]
    out = flash_kernel.flash_attention_fwd(q, k, v)
    _assert_close(out, attn.reference_attention(q, k, v), TOLS[dtype])


def test_flash_kernel_refuses_misaligned_bf16_rows(cuda):
    q = torch.zeros((1, 64, 2, 68), dtype=torch.bfloat16,
                    device=cuda)[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        flash_kernel.flash_attention_fwd(q, q, q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S", [(4, 512), (1, 513), (2, 130)])
def test_flash_kernel_at_mla_head_dims(cuda, dtype, B, S):
    """deepseek-v2-lite's prefill instance, q/k 192 and v 128 (16 heads,
    causal, scale 1/sqrt(192)): output and lse against the plain version,
    a ragged last tile at 513 and 130, two calls bit-identical."""
    rng = np.random.default_rng(21)
    q, k = (_rand(rng, (B, S, 16, 192), dtype, cuda) for _ in range(2))
    v = _rand(rng, (B, S, 16, 128), dtype, cuda)
    scale = 192 ** -0.5
    o, lse = flash_kernel.flash_attention_fwd(q, k, v, scale=scale,
                                              with_lse=True)
    assert tuple(o.shape) == (B, S, 16, 128) and o.dtype == dtype
    ref, lse_ref = flash_attention_fwd_ref(q, k, v, scale=scale)
    _assert_close(o, ref, TOLS[dtype])
    _assert_close(lse, lse_ref, LSE_TOL)
    again = flash_kernel.flash_attention_fwd(q, k, v, scale=scale)
    assert torch.equal(o, again)


def test_flash_kernel_reads_mla_layouts(cuda):
    """q/k/v as MLA builds them (k a cat of the per-head nope part and the
    broadcast rope part, v a reshape of the latent's up-projection) and as
    views into wider rows: the output of contiguous copies, bit for bit.
    Other head-dim pairs are refused."""
    rng = np.random.default_rng(22)
    B, S, H, dt = 2, 200, 16, torch.bfloat16
    kn = _rand(rng, (B, S, H, 128), dt, cuda)
    kr = _rand(rng, (B, S, 1, 64), dt, cuda)
    k = torch.cat([kn, kr.expand(B, S, H, 64)], -1)
    v = (_rand(rng, (B, S, 64), dt, cuda)
         @ _rand(rng, (64, H * 128), dt, cuda)).reshape(B, S, H, 128)
    q = _rand(rng, (B, S, H, 192 + 8), dt, cuda)[..., :192]
    wide_v = torch.zeros((B, S, H, 136), dtype=dt, device=cuda)
    wide_v[..., :128] = v
    want = flash_kernel.flash_attention_fwd(q.contiguous(), k, v)
    assert torch.equal(flash_kernel.flash_attention_fwd(q, k, v), want)
    assert torch.equal(flash_kernel.flash_attention_fwd(
        q, k, wide_v[..., :128]), want)
    _assert_close(want, flash_attention_fwd_ref(q, k, v)[0],
                  TOLS[torch.bfloat16])
    for hd, hdv in ((192, 64), (128, 192), (64, 128)):
        with pytest.raises(ValueError, match="q/k"):
            flash_kernel.flash_attention_fwd(
                q[..., :hd].contiguous(), k[..., :hd].contiguous(),
                torch.zeros((B, S, H, hdv), dtype=dt, device=cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_op_at_mla_head_dims_refuses_a_gradient_on_card(cuda, dtype):
    """The gradient through the flash op at MLA's (192, 128) on the card
    (the name is from when the op refused it there; it no longer does):
    the backward kernel against the plain
    block-recompute backward on the same (q, k, v, o, lse, do), GQA 4:1,
    causal, S = 200 (not a multiple of the tiles), and against autograd
    of the op."""
    rng = np.random.default_rng(9)
    B, S, H, KH = 2, 200, 8, 2
    q = _rand(rng, (B, S, H, 192), dtype, cuda).requires_grad_()
    k = _rand(rng, (B, S, KH, 192), dtype, cuda).requires_grad_()
    v = _rand(rng, (B, S, KH, 128), dtype, cuda).requires_grad_()
    do = _rand(rng, (B, S, H, 128), dtype, cuda)
    y = flash_ops.flash_attention(q, k, v)
    y.backward(do)
    o, lse = flash_kernel.flash_attention_fwd(q.detach(), k.detach(),
                                              v.detach(), with_lse=True)
    assert torch.equal(y.detach(), o)
    ref = flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), o,
                                  lse, do, q_chunk=64)
    for t, want in zip((q, k, v), ref):
        assert t.grad.dtype == dtype and t.grad.shape == t.shape
        _assert_close(t.grad, want, TOLS[dtype])


def test_mixtral_smoke_ring_cache_on_card(cuda):
    """mixtral's smoke model (head_dim 32: the kernels take no 16; window
    64; top-2) on the card decoding past its window through the paged
    kernel's identity table over the 64-slot ring, each step within
    RING_TOL of a full forward that takes the served routes:
    ``chip_smoke.phase_ring_cache``, the one copy of this check (its
    docstring says why the routes are replayed)."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    chip_smoke.phase_ring_cache(cuda)


def test_mixtral_smoke_ring_cache_on_card_at_window_40(cuda):
    """The same at window 40: a cache of 40 slots in 3 pages of 16, whose
    ring modulus (its logical length) is not the pages' 48; 41 decode
    steps from a prompt of 80 write every slot and wrap."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    chip_smoke.phase_ring_cache(cuda, window=chip_smoke.RING_ANY_LEN,
                                steps=chip_smoke.RING_ANY_LEN + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KH,hd,win", FLASH_BWD_SHAPES)
def test_flash_lse_and_backward_match_plain(cuda, dtype, B, S, H, KH, hd,
                                            win):
    """The forward's lse output against the plain forward's, and the
    backward kernel against the plain block-recompute backward on the same
    (q, k, v, o, lse, do); dq/dk/dv come back in the inputs' dtype, after
    the same fp32 arithmetic (bf16: one rounding apart)."""
    rng = np.random.default_rng(4)
    q, do = (_rand(rng, (B, S, H, hd), dtype, cuda) for _ in range(2))
    k, v = (_rand(rng, (B, S, KH, hd), dtype, cuda) for _ in range(2))
    o, lse = flash_kernel.flash_attention_fwd(q, k, v, window=win,
                                              with_lse=True)
    assert torch.equal(o, flash_kernel.flash_attention_fwd(q, k, v,
                                                           window=win))
    _, lse_ref = flash_attention_fwd_ref(q, k, v, window=win, q_chunk=64)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    _assert_close(lse, lse_ref, LSE_TOL)
    before = flash_kernel.flash_attention_bwd.launches
    got = flash_kernel.flash_attention_bwd(q, k, v, o, lse, do, window=win)
    torch.cuda.synchronize()
    assert flash_kernel.flash_attention_bwd.launches == before + 1
    ref = flash_attention_bwd_ref(q, k, v, o, lse, do, window=win,
                                  q_chunk=64)
    for a, b, x in zip(got, ref, (q, k, v)):
        assert a.dtype == dtype and a.shape == x.shape
        _assert_close(a, b, TOLS[dtype])


def test_flash_backward_is_deterministic(cuda):
    """No atomics: two identical calls give the same bits (bf16, GQA)."""
    rng = np.random.default_rng(5)
    q, do = (_rand(rng, (2, 384, 8, 64), torch.bfloat16, cuda)
             for _ in range(2))
    k, v = (_rand(rng, (2, 384, 2, 64), torch.bfloat16, cuda)
            for _ in range(2))
    o, lse = flash_kernel.flash_attention_fwd(q, k, v, with_lse=True)
    a = flash_kernel.flash_attention_bwd(q, k, v, o, lse, do)
    b = flash_kernel.flash_attention_bwd(q, k, v, o, lse, do)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("B,S,Sk,H,KH,hd,win", FLASH_BWD_EDGES)
def test_flash_bf16_backward_at_tile_edges(cuda, B, S, Sk, H, KH, hd, win):
    """The TMA + wgmma backward where q rows, keys or the window end inside
    a 64-row q tile or a 128-key dK/dV CTA, against the plain backward;
    a second call gives the same bits."""
    rng = np.random.default_rng(6)
    dt = torch.bfloat16
    q, do = (_rand(rng, (B, S, H, hd), dt, cuda) for _ in range(2))
    k, v = (_rand(rng, (B, Sk, KH, hd), dt, cuda) for _ in range(2))
    o, lse = flash_kernel.flash_attention_fwd(q, k, v, window=win,
                                              with_lse=True)
    got = flash_kernel.flash_attention_bwd(q, k, v, o, lse, do, window=win)
    ref = flash_attention_bwd_ref(q, k, v, o, lse, do, window=win,
                                  q_chunk=64)
    for a, b in zip(got, ref):
        _assert_close(a, b, TOLS[dt])
    again = flash_kernel.flash_attention_bwd(q, k, v, o, lse, do, window=win)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("layout", ["rows_hd_plus_8", "rows_hd_plus_4",
                                    "offset_2_bytes"])
def test_flash_backward_reads_strided_and_misaligned_inputs(cuda, layout):
    """bf16 inputs that are views into wider rows (16-byte aligned: read by
    TMA through their strides; hd + 4: copied first) or start 2 bytes past
    an aligned address (copied first) give the contiguous call's bits."""
    rng = np.random.default_rng(7)
    dt, hd = torch.bfloat16, 64
    q, do = (_rand(rng, (2, 200, 4, hd), dt, cuda) for _ in range(2))
    k, v = (_rand(rng, (2, 200, 2, hd), dt, cuda) for _ in range(2))
    o, lse = flash_kernel.flash_attention_fwd(q, k, v, with_lse=True)
    want = flash_kernel.flash_attention_bwd(q, k, v, o, lse, do)

    def make(t):
        if layout == "offset_2_bytes":
            flat = torch.empty(t.numel() + 1, dtype=dt, device=cuda)[1:]
            return flat.view(t.shape).copy_(t)
        pad = 8 if layout == "rows_hd_plus_8" else 4
        wide = torch.zeros((*t.shape[:3], hd + pad), dtype=dt, device=cuda)
        wide[..., :hd] = t
        return wide[..., :hd]
    got = flash_kernel.flash_attention_bwd(make(q), make(k), make(v),
                                           make(o), lse, make(do))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_flash_backward_is_deterministic_at_training_shape(cuda):
    """stablelm-1.6b's attention at 2 x 4096 (32 heads of 64, causal):
    two calls give the same bits."""
    rng = np.random.default_rng(8)
    q, k, v, do = (_rand(rng, (2, 4096, 32, 64), torch.bfloat16, cuda)
                   for _ in range(4))
    o, lse = flash_kernel.flash_attention_fwd(q, k, v, with_lse=True)
    a = flash_kernel.flash_attention_bwd(q, k, v, o, lse, do)
    b = flash_kernel.flash_attention_bwd(q, k, v, o, lse, do)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("hd", [32, 64, 80, 128])
def test_flash_backward_plan(cuda, hd):
    """plan_bwd reports both kernels' CTAs, each of which fits an SM."""
    plan = flash_kernel.plan_bwd(hd)
    for kern in ("dkdv", "dq"):
        assert plan[kern]["threads"] % 32 == 0
        assert 0 < plan[kern]["smem_bytes"] <= 232448
        assert plan[kern]["ctas_per_sm"] >= 1


@settings(max_examples=200, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(S=st.integers(1, 300), Sk=st.integers(1, 300),
       tiles=st.sampled_from([(64, 64), (64, 128), (128, 64), (16, 32)]),
       causal=st.booleans(),
       window=st.sampled_from([0, 1, 20, 48, 100, 257]))
def test_flash_backward_tile_rule_matches_ref(cuda, S, Sk, tiles, causal,
                                              window):
    """The tile rule as compiled into the bf16 backward kernels equals
    ref.tile_kinds, which test_torch_flash_grad.py holds against the
    mask, over the same cases."""
    got = flash_kernel.tile_kinds(S, Sk, *tiles, causal, window).numpy()
    np.testing.assert_array_equal(got, tile_kinds(S, Sk, *tiles, causal,
                                                  window))


def test_smoke_train_loop_on_card(cuda, tmp_path):
    """Two smoke-size TrainLoop steps on the card (head_dim 32: the kernels
    take no 24) from a ring-backed loader: every layer's attention runs
    the forward and backward kernels once a step, and the first step's
    loss is the CPU's within bf16 rounding."""
    import os
    from repro_torch.data import RingLoader, TokenStore, \
        make_synthetic_corpus
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainLoop, TrainLoopConfig
    from repro_torch.tree import tree_map
    cfg = get_smoke_config("stablelm-1.6b").replace(head_dim=32)
    path = make_synthetic_corpus(os.path.join(tmp_path, "tok.bin"), 20_000,
                                 cfg.vocab_size)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    card_params = tree_map(lambda t: t.to(cuda), params)
    first = next(iter(RingLoader(TokenStore(path), batch=2, seq=64)))
    _, _, cpu_m = make_train_step(cfg)(
        params, adamw_init(params),
        {k: torch.as_tensor(v) for k, v in first.items()})
    loop = TrainLoop(cfg, TrainLoopConfig(total_steps=2, ckpt_every=100,
                                          ckpt_dir=str(tmp_path / "ck"),
                                          log_every=1),
                     RingLoader(TokenStore(path), batch=2, seq=64),
                     params=card_params, device=cuda)
    fwd0 = flash_kernel.flash_attention_fwd.launches
    bwd0 = flash_kernel.flash_attention_bwd.launches
    loop.run()
    torch.cuda.synchronize()
    assert flash_kernel.flash_attention_fwd.launches - fwd0 == 2 * cfg.n_layers
    assert flash_kernel.flash_attention_bwd.launches - bwd0 == 2 * cfg.n_layers
    m0, m1 = loop.metrics_log
    assert np.isfinite(m1["loss"]) and m1["grad_norm"] > 0
    np.testing.assert_allclose(m0["loss"], float(cpu_m["loss"]), rtol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KH,hd,page,nblk", PAGED_SHAPES)
def test_paged_kernel_matches_plain(cuda, dtype, B, H, KH, hd, page, nblk):
    args = _paged_inputs(cuda, dtype, B, H, KH, hd, page, nblk)
    before = paged_kernel.paged_attention.launches
    out = paged_ops.paged_attention(*args)
    torch.cuda.synchronize()
    assert paged_kernel.paged_attention.launches == before + 1
    ref = paged_ops.paged_attention(*[a.cpu() for a in args])
    _assert_close(out.cpu(), ref, 3e-5 if dtype == torch.float32
                  else TOLS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KH,hd,page,nblk", PAGED_SHAPES)
def test_paged_kernel_lse_matches_plain(cuda, dtype, B, H, KH, hd, page,
                                        nblk):
    """With an lse pointer the kernel writes each row's log-sum-exp (1e-5
    relative of the plain version's) and the same ``out`` bits as without
    one; a zero-length row keeps the mean of V and gets lse <= -1e30."""
    q, kp, vp, table, lens = _paged_inputs(cuda, dtype, B, H, KH, hd, page,
                                           nblk)
    lens[0] = 0
    out, lse = paged_kernel.paged_attention(q, kp, vp, table, lens,
                                            with_lse=True)
    plain = paged_kernel.paged_attention(q, kp, vp, table, lens)
    assert torch.equal(out, plain)
    assert lse.dtype == torch.float32 and lse.shape == (B, H)
    ref_o, ref_lse = paged_ops.paged_attention_ref(
        *[a.cpu() for a in (q, kp, vp, table, lens)], with_lse=True)
    _assert_close(out.cpu(), ref_o, 3e-5 if dtype == torch.float32
                  else TOLS[dtype])
    assert bool((lse[0] <= -1e30).all()) and bool((ref_lse[0] <= -1e30).all())
    torch.testing.assert_close(lse[1:].cpu(), ref_lse[1:], atol=1e-5,
                               rtol=1e-5)
    via_op = paged_ops.paged_attention(q, kp, vp, table, lens, with_lse=True)
    assert torch.equal(via_op[0], out) and torch.equal(via_op[1], lse)


def _op_args(dev):
    """One small call of each kernel op on ``dev`` (bf16; the SSD's dt and
    A_log fp32): name -> positional arguments."""
    rng = np.random.default_rng(0)
    bf = torch.bfloat16
    q, k, v = (_rand(rng, (1, 128, 4, 64), bf, dev),
               _rand(rng, (1, 128, 2, 64), bf, dev),
               _rand(rng, (1, 128, 2, 64), bf, dev))
    o, lse = flash_kernel.flash_attention_fwd(q, k, v, with_lse=True) \
        if dev.type == "cuda" else flash_attention_fwd_ref(q, k, v)
    flash = (True, 0, 0.125, 64, 0, "triangular")
    paged = _paged_inputs(dev, bf, 2, 4, 2, 64, 16, 3)
    x = _rand(rng, (1, 64, 2, 16), bf, dev)
    dt = torch.nn.functional.softplus(
        _rand(rng, (1, 64, 2), torch.float32, dev))
    A_log = _rand(rng, (2,), torch.float32, dev)
    Bm, Cm = (_rand(rng, (1, 64, 8), bf, dev) for _ in range(2))
    cots = [_rand(rng, s, torch.float32, dev) for s in
            ((1, 2, 32, 2, 16), (1, 2, 2, 16, 8), (1, 2, 32, 2), (1, 2, 2))]
    return {"flash_fwd": (q, k, v, *flash),
            "flash_fwd_lse": (q, k, v, *flash),
            "flash_bwd": (q, k, v, o.contiguous(), lse.contiguous(),
                          o.contiguous(), *flash),
            "paged_attention": (*paged, 0.125),
            "paged_attention_lse": (*paged, 0.125),
            "ssd_chunk": (x, dt, A_log, Bm, Cm, 32),
            "ssd_chunk_bwd": (x, dt, A_log, Bm, Cm, *cots, 32)}


@pytest.mark.parametrize("name", sorted(_op_args(torch.device("cpu"))))
def test_kernel_ops_pass_opcheck_on_card(cuda, name):
    """Each kernel op passes ``torch.library.opcheck`` on CUDA tensors: its
    schema, its fake version against the kernel's outputs (shapes,
    dtypes, strides) and its dispatch under AOT tracing."""
    torch.library.opcheck(getattr(torch.ops.repro_torch, name),
                          _op_args(cuda)[name])


def test_paged_kernel_permuted_table_is_bit_identical(cuda):
    """The same pages under a permuted table give the same bits: the
    reduction order depends on logical position only."""
    q, kp, vp, table, _ = _paged_inputs(cuda, torch.float32, 2, 4, 2, 16,
                                        8, 4, seed=5)
    lens = torch.tensor([32, 27], dtype=torch.int32, device=cuda)
    perm = torch.randperm(kp.shape[0], generator=torch.Generator()
                          .manual_seed(6)).to(cuda)
    inv = torch.argsort(perm).to(torch.int32)
    out = paged_kernel.paged_attention(q, kp, vp, table, lens)
    out_p = paged_kernel.paged_attention(q, kp[perm], vp[perm],
                                         inv[table.long()], lens)
    assert torch.equal(out, out_p)


@pytest.mark.parametrize("B,H,KH,hd,page,nblk", PERMUTE_SHAPES)
def test_paged_kernel_permuted_table_bits_at_split_shapes(cuda, B, H, KH, hd,
                                                          page, nblk):
    """Bit identity under a permuted table where the pages are split across
    the CTAs of a cluster, and the kernel against the plain split-merge
    version and the plain version (bf16, as served)."""
    q, kp, vp, _, _ = _paged_inputs(cuda, torch.bfloat16, B, H, KH, hd, page,
                                    nblk, seed=8)
    npool = kp.shape[0]
    table = torch.arange(B * nblk, dtype=torch.int32, device=cuda) \
        .view(B, nblk)
    lens = torch.tensor([nblk * page - 1 - 5 * i for i in range(B)],
                        dtype=torch.int32, device=cuda)
    perm = torch.randperm(npool, generator=torch.Generator()
                          .manual_seed(9)).to(cuda)
    inv = torch.argsort(perm).to(torch.int32)
    out = paged_kernel.paged_attention(q, kp, vp, table, lens)
    out_p = paged_kernel.paged_attention(q, kp[perm], vp[perm],
                                         inv[table.long()], lens)
    torch.cuda.synchronize()
    assert torch.equal(out, out_p)
    plan = paged_kernel.plan(nblk, page, H // KH, hd, q.dtype)
    tol = TOLS[torch.bfloat16]
    _assert_close(out, paged_attention_split_ref(
        q, kp, vp, table, lens, n_split=plan["n_split"],
        row_tiles=plan["row_tiles"]), tol)
    _assert_close(out, paged_ops.paged_attention(
        *[a.cpu() for a in (q, kp, vp, table, lens)]).to(cuda), tol)


# (row tiles, rows a tile) the kernel takes at hd 128: at most 1024 / 128
# = 8 rows a tile, the G rows of a KV head cut evenly
ROW_TILES = {48: (6, 8), 7: (1, 7), 8: (1, 8), 6: (1, 6), 9: (2, 5)}


@pytest.mark.parametrize("G,KH", [(48, 1), (7, 8), (8, 8), (6, 2), (9, 2)])
def test_paged_kernel_row_tiles(cuda, G, KH):
    """The query rows of a KV head in row tiles at hd 128 over 34 pages of
    16 (B 4): granite-34b's G 48 in 6 tiles of 8, yi-34b's 7 and
    deepseek-67b's 8 in one, qwen2-vl's 6 in one, and G 9 in tiles of 5
    and 4 (a short last tile), as ``plan`` reports them. The kernel
    agrees with the plain version and the split twin of its tiles, and
    a zero-length row gives the mean of V over the table's slots."""
    B, H, hd, page, nblk = 4, G * KH, 128, 16, 34
    q, kp, vp, table, _ = _paged_inputs(cuda, torch.bfloat16, B, H, KH, hd,
                                        page, nblk, seed=13)
    lens = torch.tensor([nblk * page - 1, 0, 300, 17], dtype=torch.int32,
                        device=cuda)
    tol = TOLS[torch.bfloat16]
    plain = paged_ops.paged_attention(
        *[a.cpu() for a in (q, kp, vp, table, lens)]).to(cuda)
    mean_v = vp[table[1].long()].float().reshape(nblk * page, KH, hd) \
        .mean(0).repeat_interleave(G, dim=0)
    plan = paged_kernel.plan(nblk, page, G, hd, q.dtype)
    assert (plan["row_tiles"], plan["rows_per_tile"]) == ROW_TILES[G]
    out = paged_kernel.paged_attention(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    _assert_close(out, plain, tol)
    _assert_close(out, paged_attention_split_ref(
        q, kp, vp, table, lens, n_split=plan["n_split"],
        row_tiles=plan["row_tiles"]), tol)
    _assert_close(out[1], mean_v, tol)


@pytest.mark.parametrize("KH,hd", [(32, 64), (2, 128)])
def test_paged_kernel_over_pager_held_pools(cuda, KH, hd):
    """Pages of a real-shaped cache put into a KVPager whose frames hold
    fewer pages than the cache (both spill tiers fill), refaulted and
    pinned: the kernel over ``device_pools()`` through the table built
    from ``slot_of`` (not the identity) gives the bits of the kernel over
    the dense pools through the identity table."""
    from repro_torch.serve import KVPager, PagerConfig
    B, H, page, nblk = 4, 32 if KH == 32 else 12, 16, 34
    q, kp, vp, _, _ = _paged_inputs(cuda, torch.bfloat16, B, H, KH, hd,
                                    page, nblk, seed=12)
    kd, vd = kp[:B * nblk], vp[:B * nblk]
    # frames for two sequences and 8 pages more; sequence 0's pages spill
    # to the host tier, the others' to the cold tier
    pager = KVPager(PagerConfig(n_hbm_pages=2 * nblk + 8, page_tokens=page,
                                kv_heads=KH, head_dim=hd,
                                host_pages=nblk, nvme_pages=4 * nblk))
    for i in range(B * nblk):
        pager.put_page_sync((i // nblk, i % nblk), kd[i], vd[i])
    rows = (0, 1)                 # evicted by sequences 2 and 3: refaults
    want = [(b, j) for b in rows for j in range(nblk)]
    slots = {key: pager.fix_page_sync(key) for key in want}
    assert pager.pool.writebacks > 0 and pager.host_reads > 0 \
        and pager.cold_reads > 0
    k_pool, v_pool = pager.device_pools()
    table = torch.tensor([[slots[(b, j)] for j in range(nblk)]
                          for b in rows], dtype=torch.int32, device=cuda)
    ident = torch.arange(B * nblk, dtype=torch.int32, device=cuda) \
        .view(B, nblk)[list(rows)].contiguous()
    assert not torch.equal(table, ident)
    lens = torch.tensor([nblk * page - 1, nblk * page - 7],
                        dtype=torch.int32, device=cuda)
    qr = q[list(rows)].contiguous()
    out = paged_kernel.paged_attention(qr, k_pool, v_pool, table, lens)
    dense = paged_kernel.paged_attention(qr, kd, vd, ident, lens)
    torch.cuda.synchronize()
    assert torch.equal(out, dense)
    for idx in slots.values():
        pager.pool.unfix(idx)


@pytest.mark.parametrize("hd", [64, 80])
def test_paged_kernel_fp32_serving_split_matches_split_ref(cuda, hd):
    """fp32 at a serving split (B 4, 32 KV heads, 34 pages of 16: 7 CTAs
    of 5 pages) against the plain split-merge version at the fp32
    tolerance, where a fault in the merge's order or weights would show;
    one row of length 0 and one that leaves the last split empty."""
    B, H, page, nblk = 4, 32, 16, 34
    q, kp, vp, _, _ = _paged_inputs(cuda, torch.float32, B, H, H, hd, page,
                                    nblk, seed=12)
    table = torch.arange(B * nblk, dtype=torch.int32, device=cuda) \
        .view(B, nblk)
    lens = torch.tensor([543, 0, 30 * page, 97], dtype=torch.int32,
                        device=cuda)
    plan = paged_kernel.plan(nblk, page, 1, hd, q.dtype)
    assert (plan["n_split"], plan["pages_per_split"]) == (7, 5)
    out = paged_kernel.paged_attention(q, kp, vp, table, lens)
    _assert_close(out, paged_attention_split_ref(q, kp, vp, table, lens,
                                                 n_split=plan["n_split"]),
                  3e-5)


def test_paged_kernel_every_decode_length(cuda):
    """Every length of the serving decode run (513 to 543: 33 and 34 pages
    of 16) at the stablelm shape, against the plain version."""
    B, H, hd, page, Smax = 4, 32, 64, 16, 544
    rng = np.random.default_rng(11)
    q = _rand(rng, (B, H, hd), torch.bfloat16, cuda)
    kc = _rand(rng, (B * Smax // page, page, H, hd), torch.bfloat16, cuda)
    vc = _rand(rng, (B * Smax // page, page, H, hd), torch.bfloat16, cuda)
    for pos in range(512, 543):
        table, lens = lm.identity_pages(B, Smax, pos, 0, cuda)
        out = paged_kernel.paged_attention(q, kc, vc, table, lens)
        ref = paged_attention_split_ref(q, kc, vc, table, lens,
                                        n_split=paged_kernel.plan(
                                            table.shape[1], page, 1, hd,
                                            q.dtype)["n_split"])
        _assert_close(out, ref, TOLS[torch.bfloat16])
        _assert_close(out, paged_ops.paged_attention_ref(
            q, kc, vc, table, lens), TOLS[torch.bfloat16])


def _ssd_inputs(dev, B, S, nh, hp, ns, dtype=torch.float32, seed=7,
                dt_scale=1.0):
    """tests/test_kernels.py's SSD distributions, dt times ``dt_scale``;
    x/B/C in ``dtype``."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = _rand(rng, (B, S, nh, hp), dtype, dev) * 0.5
    dt = torch.nn.functional.softplus(_rand(rng, (B, S, nh), torch.float32,
                                            dev)) * dt_scale
    A_log = torch.from_numpy((rng.standard_normal(nh) * 0.3).astype(f)) \
        .to(dev)
    Bm = _rand(rng, (B, S, ns), dtype, dev) * 0.5
    Cm = _rand(rng, (B, S, ns), dtype, dev) * 0.5
    return x, dt, A_log, Bm, Cm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,nh,hp,ns,cl", SSD_SHAPES)
def test_ssd_kernel_matches_plain(cuda, dtype, B, S, nh, hp, ns, cl):
    """Each of the four pieces against ssd_chunk_ref on the same (bf16 or
    fp32) inputs, both computing in fp32, and in bf16 also against the
    split arithmetic of the tensor-core instance (ssd_chunk_split_ref)."""
    args = _ssd_inputs(cuda, B, S, nh, hp, ns, dtype)
    before = ssd_kernel.ssd_chunk_call.launches
    out = ssd_kernel.ssd_chunk_call(*args, chunk=cl)
    torch.cuda.synchronize()
    assert ssd_kernel.ssd_chunk_call.launches == before + 1
    refs = {"plain": ssd_chunk_ref(*args, chunk=cl)}
    if dtype == torch.bfloat16:
        refs["split"] = ssd_chunk_split_ref(*args, chunk=cl)
    for what, ref in refs.items():
        for name, o, r in zip(("y_diag", "states", "exp_cs", "exp_tot"),
                              out, ref):
            assert o.dtype == torch.float32 and o.shape == r.shape, name
            torch.testing.assert_close(o, r, atol=SSD_ATOL, rtol=SSD_RTOL,
                                       msg=f"{name} vs {what}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hp,ns", SSD_HEAD_SWEEP)
def test_ssd_kernel_head_shapes(cuda, dtype, hp, ns):
    """Every hp and ns the serving configurations and tests use (in bf16
    the tensor cores), two chunks of 128."""
    test_ssd_kernel_matches_plain(cuda, dtype, 2, 256, 3, hp, ns, 128)


def test_ssd_kernel_plan(cuda):
    """Which kernel a call runs: the decode kernel at cl 1, the tensor
    cores for bf16 chunks, the scalar kernel for fp32 chunks and for
    shapes the tensor-core instance does not take."""
    bf, f32 = torch.bfloat16, torch.float32
    for shape, dtype, path in (((4, 512, 80, 64, 64, 256), bf, "mma"),
                               ((4, 512, 24, 64, 128, 256), bf, "mma"),
                               ((4, 1, 80, 64, 64, 1), bf, "decode"),
                               ((2, 6, 4, 16, 8, 1), f32, "decode"),
                               ((2, 128, 4, 32, 16, 32), f32, "scalar"),
                               ((1, 64, 3, 12, 20, 32), bf, "scalar")):
        p = ssd_kernel.plan(*shape, dtype)
        assert p["path"] == path, (shape, p)
        assert p["ctas"] > 0 and p["ctas_per_sm"] >= 1, (shape, p)
    zamba = ssd_kernel.plan(4, 512, 80, 64, 64, 256, bf)
    assert zamba["heads_per_cta"] == 2 and zamba["spill_bytes"] == 0
    assert zamba["ctas"] >= zamba["sms"], zamba


def test_ssd_op_on_card_matches_oracle(cuda):
    """The full SSD through the kernel (padding, initial state, the
    inter-chunk recurrence) against the plain chunked SSD."""
    x, dt, A_log, Bm, Cm = _ssd_inputs(cuda, 2, 100, 4, 32, 16)
    D = torch.ones(4, device=cuda)
    st0 = torch.randn((2, 4, 32, 16), generator=torch.Generator(cuda)
                      .manual_seed(0), device=cuda) * 0.2
    y, st = ssd_ops.ssd(x, dt, A_log, Bm, Cm, D, chunk=32, state=st0)
    yr, sr = ssd_ref(x, dt, A_log, Bm, Cm, D, 32, state=st0)
    torch.testing.assert_close(y, yr, atol=SSD_ATOL, rtol=SSD_RTOL)
    torch.testing.assert_close(st, sr, atol=SSD_ATOL, rtol=SSD_RTOL)


def _ssd_bwd_inputs(dev, B, S, nh, hp, ns, cl, dtype, seed=11,
                    dt_scale=1.0):
    args = _ssd_inputs(dev, B, S, nh, hp, ns, dtype, seed, dt_scale)
    rng = np.random.default_rng(seed + 1)
    nc = S // cl
    cots = [_rand(rng, shape, torch.float32, dev) for shape in (
        (B, nc, cl, nh, hp), (B, nc, nh, hp, ns), (B, nc, cl, nh),
        (B, nc, nh))]
    return args + tuple(cots)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,nh,hp,ns,cl", SSD_BWD_SHAPES)
def test_ssd_backward_kernel_matches_plain(cuda, dtype, B, S, nh, hp, ns,
                                           cl):
    """dx, ddt, dA_log, dB and dC of the backward kernel against the plain
    explicit backward (ssd_chunk_bwd_ref) on the same inputs and four
    nonzero cotangents, in the dtypes of the inputs."""
    _check_ssd_bwd(cuda, dtype, B, S, nh, hp, ns, cl)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,nh,hp,ns,cl", SSD_BWD_SLOW_SHAPES)
def test_ssd_backward_kernel_slow_decay(cuda, dtype, B, S, nh, hp, ns, cl):
    """The same with slow decay, where exp(tot), w_j and the far tiles'
    L weigh as much as the other terms."""
    _, dt, A_log = _ssd_bwd_inputs(cuda, B, S, nh, hp, ns, cl, dtype,
                                   dt_scale=SLOW_DT)[:3]
    tot = dt.reshape(B, S // cl, cl, nh).sum(2) * -torch.exp(A_log)
    assert float(tot.exp().mean()) > 0.05
    _check_ssd_bwd(cuda, dtype, B, S, nh, hp, ns, cl, SLOW_DT)


def _check_ssd_bwd(cuda, dtype, B, S, nh, hp, ns, cl, dt_scale=1.0,
                   split=False):
    """The kernel against ssd_chunk_bwd_ref (and, with ``split``, against
    the split twin ssd_chunk_bwd_split_ref); returns the first call's
    outputs and the inputs."""
    args = _ssd_bwd_inputs(cuda, B, S, nh, hp, ns, cl, dtype,
                           dt_scale=dt_scale)
    before = ssd_kernel.ssd_chunk_bwd.launches
    got = ssd_kernel.ssd_chunk_bwd(*args, chunk=cl)
    torch.cuda.synchronize()
    assert ssd_kernel.ssd_chunk_bwd.launches == before + 1
    refs = {"plain": ssd_chunk_bwd_ref(*args, chunk=cl)}
    if split:
        refs["split"] = ssd_chunk_bwd_split_ref(*args, chunk=cl)
    ref = refs["plain"]
    for what, other in refs.items():
        for i, (name, a, b) in enumerate(zip(("dx", "ddt", "dA_log", "dB",
                                              "dC"), got, other)):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            rtol = 2.0 ** -7 if a.dtype == torch.bfloat16 else 0.0
            scale = float((ref[1].abs() * args[1]).sum()) if i == 2 \
                else float(ref[i].float().abs().max())
            torch.testing.assert_close(a.float(), b.float(), rtol=rtol,
                                       atol=SSD_BWD_TOL * scale,
                                       msg=f"{name} vs {what}")
    return got, args


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_is_deterministic(cuda, dtype):
    """No atomics: two calls give the same bits."""
    args = _ssd_bwd_inputs(cuda, *SSD_BWD_SHAPES[1], dtype)
    a = ssd_kernel.ssd_chunk_bwd(*args, chunk=SSD_BWD_SHAPES[1][-1])
    b = ssd_kernel.ssd_chunk_bwd(*args, chunk=SSD_BWD_SHAPES[1][-1])
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dt_scale", [1.0, SLOW_DT])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,nh,hp,ns,cl", SSD_BWD_EVERY)
def test_ssd_backward_at_every_shape(cuda, dtype, B, S, nh, hp, ns, cl,
                                     dt_scale):
    """Every checked shape, both dtypes, fast and slow decay: the kernel
    against the plain explicit backward and, in bf16, against the split
    arithmetic of its tensor-core instance, each within SSD_BWD_TOL of
    the gradient's scale (bf16 outputs one ulp more); a second call gives
    the same bits."""
    got, args = _check_ssd_bwd(cuda, dtype, B, S, nh, hp, ns, cl, dt_scale,
                               split=dtype == torch.bfloat16)
    again = ssd_kernel.ssd_chunk_bwd(*args, chunk=cl)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("B,S,nh,hp,ns,cl", [(1, 4096, 80, 64, 64, 256),
                                             (2, 4096, 24, 64, 128, 256),
                                             (2, 256, 3, 32, 16, 128),
                                             (1, 200, 5, 16, 8, 100)])
def test_ssd_backward_plan(cuda, B, S, nh, hp, ns, cl):
    """The bf16 backward's launches: no kernel spills to local memory;
    the head kernel's CTAs are (key tiles, head groups of BWD_GROUP, batch
    · chunks) and the dsum kernel's (tile pairs, batch · chunks), as the
    rule mirrored in ref.bwd_head_groups / bwd_tile_pairs has them; every
    kernel fits an SM."""
    p = ssd_kernel.plan_bwd(B, S, nh, hp, ns, cl, torch.bfloat16)
    assert p["heads_per_cta"] == BWD_GROUP
    k = p["kernels"]
    for name, v in k.items():
        assert v["spill_bytes"] == 0, (name, v)
        assert v["ctas_per_sm"] >= 1, (name, v)
    n_kt, BC = -(-cl // 64), B * (S // cl)
    assert k["ssd_bwd_mma_head_kernel"]["ctas"] == \
        n_kt * len(bwd_head_groups(nh)) * BC
    assert k["ssd_bwd_dsum_kernel"]["ctas"] == len(bwd_tile_pairs(cl)) * BC
    assert k["ssd_bwd_mma_dbc_kernel"]["ctas"] == \
        2 * n_kt * p["column_splits"] * BC
    assert k["ssd_bwd_finish_kernel"]["ctas"] == nh * BC


def test_ssd_backward_copies_misaligned_bf16_inputs(cuda):
    """bf16 calls read their inputs by 16-byte cp.async: inputs that do
    not start on 16 bytes (views one element into a larger buffer) are
    copied by the wrapper, with the same bits as aligned inputs."""
    args = _ssd_bwd_inputs(cuda, 2, 128, 4, 32, 16, 32, torch.bfloat16)
    shifted = []
    for t in args:
        buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=cuda)
        v = buf[1:1 + t.numel()].view(t.shape)
        v.copy_(t)
        assert v.is_contiguous() and v.data_ptr() % 16
        shifted.append(v)
    a = ssd_kernel.ssd_chunk_bwd(*args, chunk=32)
    b = ssd_kernel.ssd_chunk_bwd(*shifted, chunk=32)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_ssd_backward_refuses_shapes_it_does_not_take(cuda):
    """hp above 64, ns above 128 or not a multiple of 4, chunks above
    256: a ValueError, not a silent fallback."""
    for hp, ns, cl in ((128, 16, 32), (32, 256, 32), (32, 10, 32),
                       (32, 16, 512)):
        args = _ssd_bwd_inputs(cuda, 1, 512, 2, hp, ns, cl, torch.float32)
        with pytest.raises(ValueError, match="SSD backward"):
            ssd_kernel.ssd_chunk_bwd(*args, chunk=cl)


def test_smoke_hybrid_train_on_card(cuda, tmp_path):
    """Two smoke zamba2-2.7b train steps on the card (remat, 2
    microbatches): every Mamba2 layer runs the SSD chunk kernel twice and
    its backward kernel once a microbatch, and the first step's loss is
    the CPU's within bf16 rounding."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init
    cfg = get_smoke_config("zamba2-2.7b").replace(remat=True, microbatches=2)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab_size, (4, 64)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tok),
             "labels": torch.from_numpy(np.roll(tok, -1, 1))}
    _, _, cpu_m = make_train_step(cfg)(params, adamw_init(params), batch)
    card = _to(lm.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu"), cuda)
    step = make_train_step(cfg)
    opt = adamw_init(card)
    f0 = ssd_kernel.ssd_chunk_call.launches
    b0 = ssd_kernel.ssd_chunk_bwd.launches
    card_batch = {k: v.to(cuda) for k, v in batch.items()}
    card, opt, m0 = step(card, opt, card_batch)
    card, opt, m1 = step(card, opt, card_batch)
    torch.cuda.synchronize()
    assert ssd_kernel.ssd_chunk_call.launches - f0 == 2 * 2 * 2 * cfg.n_layers
    assert ssd_kernel.ssd_chunk_bwd.launches - b0 == 2 * 2 * cfg.n_layers
    assert np.isfinite(float(m1["loss"])) and float(m1["grad_norm"]) > 0
    np.testing.assert_allclose(float(m0["loss"]), float(cpu_m["loss"]),
                               rtol=2e-2)


def test_smoke_serve_on_card_matches_cpu(cuda):
    """The smoke config (head_dim widened to a kernel-supported 32) served
    on the card through both kernels gives the CPU's tokens in fp32."""
    cfg = get_smoke_config("stablelm-1.6b").replace(
        head_dim=32, compute_dtype="float32")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    cpu = ServeLoop(cfg, params, max_len=32, device="cpu").generate(prompt, 6)
    f0 = flash_kernel.flash_attention_fwd.launches
    p0 = paged_kernel.paged_attention.launches
    gpu_params = _to(params, cuda)
    out = ServeLoop(cfg, gpu_params, max_len=32, device=cuda) \
        .generate(prompt, 6)
    torch.cuda.synchronize()
    assert flash_kernel.flash_attention_fwd.launches - f0 == cfg.n_layers
    assert paged_kernel.paged_attention.launches - p0 == cfg.n_layers * 5
    assert torch.equal(out.cpu(), cpu)


def _to(tree, dev):
    return {k: (_to(v, dev) if isinstance(v, dict) else v.to(dev))
            for k, v in tree.items()}


def test_smoke_hybrid_serve_on_card_matches_cpu(cuda):
    """Smoke zamba2-2.7b (hybrid: every kernel) on the card gives the
    CPU's tokens in fp32, with the launch counts of its main path."""
    cfg = get_smoke_config("zamba2-2.7b").replace(compute_dtype="float32")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    cpu = ServeLoop(cfg, params, max_len=32, device="cpu").generate(prompt, 6)
    counts = (ssd_kernel.ssd_chunk_call, flash_kernel.flash_attention_fwd,
              paged_kernel.paged_attention)
    before = [c.launches for c in counts]
    out = ServeLoop(cfg, _to(params, cuda), max_len=32, device=cuda) \
        .generate(prompt, 6)
    torch.cuda.synchronize()
    G = cfg.n_layers // cfg.attn_every
    assert [c.launches - b for c, b in zip(counts, before)] == \
        [cfg.n_layers * 6, G, G * 5]
    assert torch.equal(out.cpu(), cpu)


@pytest.fixture
def card_mesh(cuda, tmp_path):
    """The 1 x 1 ("data", "model") mesh over a one-rank NCCL group (a
    FileStore: no network), destroyed after the test."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1,
        device_id=torch.device("cuda", 0))
    try:
        yield make_local_mesh()
    finally:
        dist.destroy_process_group()


def test_mesh_train_step_on_card(card_mesh):
    """A smoke stablelm train step (head_dim 32, remat) on the 1 x 1 mesh:
    the kernels run on the local blocks, the same kernels on the same
    bytes as the step without a mesh, so the loss and every updated leaf
    are the same bits."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import partitioning as part
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_leaves, tree_map
    cuda = torch.device("cuda")
    cfg = get_smoke_config("stablelm-1.6b").replace(head_dim=32, remat=True)
    params = lm.init_params(cfg, torch.Generator(cuda).manual_seed(0),
                            device=cuda)
    g = torch.Generator(cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 128), generator=g,
                         device=cuda)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    rules = part.rules_for(card_mesh, 2)
    p0 = tree_map(lambda t: t.clone(), params)
    p0, _, m0 = make_train_step(cfg)(p0, adamw_init(p0), batch)
    p1 = lm.place_params(cfg, params, card_mesh, rules)
    fwd0 = flash_kernel.flash_attention_fwd.launches
    bwd0 = flash_kernel.flash_attention_bwd.launches
    p1, _, m1 = make_train_step(cfg, card_mesh, rules)(p1, adamw_init(p1),
                                                       batch)
    torch.cuda.synchronize()
    assert flash_kernel.flash_attention_fwd.launches - fwd0 == 2 * cfg.n_layers
    assert flash_kernel.flash_attention_bwd.launches - bwd0 == cfg.n_layers
    assert float(part.full(m1["loss"])) == float(m0["loss"])
    for a, b in zip(tree_leaves(p0), tree_leaves(p1)):
        assert torch.equal(a, part.full(b))


def test_a2a_over_one_rank_is_identity_on_card(card_mesh):
    """The explicit all-to-all through NCCL's all_to_all_single over the
    one-rank 'model' group, and the MoE dispatch/combine on DTensors."""
    from repro_torch.distributed.a2a import a2a, moe_dispatch_combine
    from repro_torch.models import partitioning as part
    x = torch.arange(2 * 16 * 4 * 3 * 5, dtype=torch.float32,
                     device="cuda").reshape(2, 16, 4, 3, 5)
    group = card_mesh.get_group("model")
    assert torch.equal(a2a(x, group, split_axis=2, concat_axis=1), x)
    dispatch, combine = moe_dispatch_combine(card_mesh, ("data",))
    xg = part.place(x, part.sharding_for(("batch", "act_seq"), card_mesh))
    xe = dispatch(xg)
    assert torch.equal(xe.full_tensor(), x)
    assert torch.equal(combine(xe).full_tensor(), x)
