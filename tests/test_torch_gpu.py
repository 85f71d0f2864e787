"""The port's CUDA kernels on a card, each held against its plain PyTorch
version, and the smoke serving path on the card against the CPU. Every
test here carries the ``gpu`` marker and skips without a card; the file
imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_fwd_ref)
from repro_torch.kernels.paged_attn import kernel as paged_kernel
from repro_torch.kernels.paged_attn import ops as paged_ops
from repro_torch.kernels.paged_attn.ref import paged_attention_split_ref
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import (ssd_chunk_ref,
                                              ssd_chunk_split_ref, ssd_ref)
from repro_torch.models import attention as attn
from repro_torch.models import lm
from repro_torch.serve import ServeLoop

pytestmark = pytest.mark.gpu

TOLS = {torch.float32: 2e-5, torch.bfloat16: 2e-2}    # tests/test_kernels.py
FLASH_SHAPES = [(2, 256, 4, 2, 64, 0), (1, 512, 4, 1, 128, 0),
                (2, 128, 8, 8, 32, 64), (1, 256, 2, 2, 64, 128),
                (2, 200, 4, 2, 64, 48),                # ragged, windowed
                (2, 192, 4, 4, 80, 0), (1, 200, 4, 2, 80, 0)]   # zamba2 hd
PAGED_SHAPES = [(2, 4, 2, 64, 32, 4), (3, 8, 2, 64, 16, 8),
                (1, 4, 4, 128, 64, 2),
                (2, 16, 4, 128, 64, 5)]                # GQA, hd 128, pages of 64
# the backward: GQA, hd 32-128, a window, S = 513 and S = 130 (not a
# multiple of the 64-row tiles); lse is fp32 arithmetic in both kernels
# (the bf16 kernel keeps its max in log2 units): measured <= 9.5e-7
FLASH_BWD_SHAPES = [(2, 256, 4, 2, 64, 0), (1, 513, 4, 1, 128, 0),
                    (2, 128, 8, 8, 32, 64), (1, 200, 4, 2, 80, 48),
                    (2, 130, 4, 4, 64, 0)]
LSE_TOL = 1e-5
# B, H, KH, hd, page, nblk: both serving shapes (34 pages of 16) and an nblk
# that is not a multiple of its split (11 pages -> 6 CTAs of 2)
PERMUTE_SHAPES = [(4, 32, 32, 64, 16, 34), (4, 32, 32, 80, 16, 34),
                  (2, 8, 2, 64, 16, 11)]
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
    n_split = paged_kernel.plan(nblk, page, H // KH, hd, q.dtype)["n_split"]
    tol = TOLS[torch.bfloat16]
    _assert_close(out, paged_attention_split_ref(q, kp, vp, table, lens,
                                                 n_split=n_split), tol)
    _assert_close(out, paged_ops.paged_attention(
        *[a.cpu() for a in (q, kp, vp, table, lens)]).to(cuda), tol)


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


def _ssd_inputs(dev, B, S, nh, hp, ns, dtype=torch.float32, seed=7):
    """tests/test_kernels.py's SSD distributions; x/B/C in ``dtype``."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = _rand(rng, (B, S, nh, hp), dtype, dev) * 0.5
    dt = torch.nn.functional.softplus(_rand(rng, (B, S, nh), torch.float32,
                                            dev))
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
