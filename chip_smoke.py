#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root, on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits nonzero):

1. the card's name, count and power limit; build the four CUDA kernel
   sources (flash attention forward and backward, paged attention, the
   Mamba2 SSD chunk step) from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, in parallel) and print the compiler's register / shared-memory
   / spill report;
2. each kernel against its plain PyTorch version on CUDA tensors: the
   shape sweeps of ``tests/test_kernels.py``, a zero-length decode row, a
   permuted page table (bit-identical output, also at both serving shapes
   and at a page count that is not a multiple of the split), the paged
   kernel against the plain split-merge version (bf16, and fp32 at the
   serving split) and at every length of the decode run, flash at
   head_dim 80 and with ragged S at the tile edges, Sk != S, a window and
   strided views, the SSD chunk kernel piece by piece (an initial state,
   one-token chunks, a padded S, a chunk that is not a multiple of 16, hp
   16/32/64 x ns 8..128, a shape for its scalar kernel), in bf16 also
   against the split arithmetic of its tensor-core instance, and the full
   SSD against the plain chunked SSD, the flash forward's lse output and
   the flash backward kernel against the plain forward and block-recompute
   backward (bf16 and fp32, head_dim 32/64/80/128, GQA, a window, S = 513
   and S = 130), and every kernel at the shapes of the serving and
   training runs;
3. the main paths, each through ``ServeLoop.generate`` at full width with
   random weights from a seeded CUDA generator and bf16 compute, 4 prompts
   of 512 tokens and 32 new tokens: ``stablelm-1.6b`` (dense: flash at
   prefill, paged at decode), ``zamba2-2.7b`` (hybrid: the SSD kernel in
   each of its 54 Mamba2 layers at prefill and at every decode step, flash
   and paged in the 9 applications of its tied attention block) and
   ``mamba2-130m`` (ssm: the SSD kernel in its 24 layers). The launch
   counters, set to 0 just before each run and read just after, must
   equal what that path launches; each model's first decode step is held
   against a full forward over prompt + token. Then the training path:
   ``TrainLoop`` on ``stablelm-1.6b`` at full width and full depth (24
   layers, each rematerialised) for 6 AdamW steps of 2 x 4096 tokens from
   a ``RingLoader`` over a synthetic corpus (no checkpoint is due in the
   run: a full-width one is 26 GB); the counters must show 48 forward and
   24 backward flash launches a step. One step's loss and gradients at
   full width and 2 layers are held against the same step with attention
   through autograd of the plain ``reference_attention``; a smoke-size
   run that crashes at step 8 and restarts from the ring checkpoint of
   step 5 must end bitwise equal to the uninterrupted run, under
   ``torch.use_deterministic_algorithms(True)``;
4. device times (CUDA events over launches queued behind a held stream,
   after warm-up) of each kernel, its plain version, its bound and, where
   one PyTorch call computes the same function, that call as a yardstick
   the port never calls, at the serving shapes (paged at the first and
   last decode lengths, 33 and 34 pages, with its cluster shape; flash
   with its CTA shape; the SSD kernel with its plan, also at a decode
   step's chunk of one token, bound at the TF32 tensor-core rate or the
   bytes); each model's prefill and decode times; the train step's time
   and tokens/s, the flash backward at the training shape beside its
   bound and the backward of ``scaled_dot_product_attention``, and the
   flash forward at the training shape;
5. where the time goes: ``torch.profiler`` over one prefill and eight
   decode steps of each model, and over one train step (forward and
   backward, then the optimizer), device busy share and kernel time by
   kind.

The last lines are a JSON object with one entry per kernel, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
Without a CUDA device the script prints no result and exits 2.
"""

from __future__ import annotations

import gc
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# cuBLAS is deterministic only with a fixed workspace, which must be set
# before CUDA initialises (the restart check runs deterministically)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch                                                  # noqa: E402
import torch.nn.functional as F                               # noqa: E402

from repro_torch.checkpoint import Checkpointer                # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data import (RingLoader, TokenStore,        # noqa: E402
                              make_synthetic_corpus)
from repro_torch.kernels import _build                        # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash_kernel  # noqa
from repro_torch.kernels.flash_attention import ops as flash_ops        # noqa
from repro_torch.kernels.flash_attention.ref import (        # noqa: E402
    flash_attention_bwd_ref, flash_attention_fwd_ref)
from repro_torch.kernels.paged_attn import kernel as paged_kernel       # noqa
from repro_torch.kernels.paged_attn import ops as paged_ops             # noqa
from repro_torch.kernels.paged_attn.ref import paged_attention_split_ref  # noqa
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel           # noqa
from repro_torch.kernels.ssd_scan import ops as ssd_ops                 # noqa
from repro_torch.kernels.ssd_scan.ref import (ssd_chunk_ref,         # noqa
                                              ssd_chunk_split_ref, ssd_ref)
from repro_torch.launch.steps import (loss_and_grads,        # noqa: E402
                                      make_train_step)
from repro_torch.models import attention as attn               # noqa: E402
from repro_torch.models import lm                              # noqa: E402
from repro_torch.optim import (adamw_init, adamw_update,       # noqa: E402
                               cosine_schedule)
from repro_torch.serve import ServeLoop                        # noqa: E402
from repro_torch.train import TrainLoop, TrainLoopConfig       # noqa: E402
from repro_torch.tree import tree_leaves, tree_map             # noqa: E402

# NVIDIA H100 SXM data sheet (dense, no sparsity), at the 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# the SSD kernel's products run on the tensor cores from split operands:
# its bound takes the function's operations at the TF32 rate
SSD_RATE = ("TF32 tensor cores", 495e12)

TOLS = {torch.float32: 2e-5, torch.bfloat16: 2e-2}     # tests/test_kernels.py
PAGED_TOL_F32 = 3e-5
SSD_ATOL, SSD_RTOL = 2e-5, 2e-4                        # tests/test_kernels.py
FLASH_SHAPES = [(2, 256, 4, 2, 64, 0), (1, 512, 4, 1, 128, 0),
                (2, 128, 8, 8, 32, 64), (1, 256, 2, 2, 64, 128)]
PAGED_SHAPES = [(2, 4, 2, 64, 32, 4), (3, 8, 2, 64, 16, 8),
                (1, 4, 4, 128, 64, 2),
                (2, 16, 4, 128, 64, 5)]                # GQA, hd 128, pages of 64
SSD_SHAPES = [(2, 128, 4, 32, 16, 32), (1, 256, 8, 16, 32, 64),
              (2, 64, 2, 64, 64, 64)]                  # B, S, nh, hp, ns, cl
KERNELS = {"flash_attention_fwd": flash_kernel.flash_attention_fwd,
           "flash_attention_bwd": flash_kernel.flash_attention_bwd,
           "paged_attention": paged_kernel.paged_attention,
           "ssd_chunk_call": ssd_kernel.ssd_chunk_call}
# the flash backward against the plain block-recompute backward: the same
# fp32 arithmetic from the same inputs, so TOLS (bf16: one rounding of the
# outputs); the lse output is fp32 in both (measured <= 9.5e-7)
FLASH_BWD_SHAPES = [(2, 256, 4, 2, 64, 0), (1, 513, 4, 1, 128, 0),
                    (2, 128, 8, 8, 32, 64), (1, 200, 4, 2, 80, 48),
                    (2, 130, 4, 4, 64, 0), (1, 513, 8, 2, 64, 100)]
LSE_TOL = 1e-5

# the serving runs: 4 prompts x 512 tokens, 32 new tokens, one per model
ARCHS = ("stablelm-1.6b", "zamba2-2.7b", "mamba2-130m")
BATCH, PROMPT, NEW, MAX_LEN = 4, 512, 32, 544
# first decode step vs a full forward, both bf16 compute through every
# layer (different GEMM shapes, flash vs paged attention): logits agree to
# within bf16 rounding carried through the layers, (atol, rtol) per family.
# mamba2-130m's decode step repeats the forward's arithmetic for that token
# (a one-token chunk runs the same kernel sums) and has matched it bit for
# bit; zamba2-2.7b's 54 Mamba2 layers carry the rounding of 9 attention
# blocks further than stablelm's 24 layers: 0.445 at |logit| <= 4.2 on the
# H100 with the wgmma flash kernel (0.256 with the mma.sync one) against
# stablelm's 0.078 at <= 5.0
LOGIT_TOLS = {"dense": (0.15, 0.05), "hybrid": (0.4, 0.05),
              "ssm": (0.15, 0.05)}

# the training run: stablelm-1.6b at full width and depth, train_4k's
# sequence (configs/base.py), a global batch cut from 256 to 2
TRAIN_ARCH = "stablelm-1.6b"
TRAIN_PATH = "train " + TRAIN_ARCH
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 4096, 6
# one step at full width and 2 layers, flash kernels vs autograd of the
# plain attention, both bf16 compute: the loss to 2e-3 relative and each
# gradient leaf to 2e-2 relative L2 (a few bf16 roundings, 2^-8 each)
GRAD_LOSS_RTOL, GRAD_REL_L2 = 2e-3, 2e-2
RESTART_STEPS, RESTART_CKPT, RESTART_CRASH = 10, 5, 8


def log(*a):
    print(*a, flush=True)


def rand(rng, shape, dtype, dev, scale=1.0):
    a = rng.standard_normal(shape, dtype=np.float32) * scale
    return torch.from_numpy(a).to(dev, dtype)


def check_close(what, out, ref, atol, rtol):
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{what}: non-finite output")
    err = (out - ref).abs()
    bad = err > atol + rtol * ref.abs()
    max_err = err.max().item()
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} elements outside "
                             f"atol={atol} rtol={rtol}; max abs err "
                             f"{max_err:.3e}")
    return max_err


_CYCLES_PER_MS = []


def hold_stream(ms):
    """Keep the current stream busy for about ``ms`` with a spin kernel
    (``torch.cuda._sleep``, calibrated once by CUDA events)."""
    if not _CYCLES_PER_MS:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        torch.cuda._sleep(10 ** 7)
        e1.record()
        torch.cuda.synchronize()
        _CYCLES_PER_MS.append(10 ** 7 / e0.elapsed_time(e1))
    torch.cuda._sleep(int(ms * _CYCLES_PER_MS[0]))


def cuda_ms(fn, n_sets, reps, warmup=3):
    """Mean device ms per call over ``reps`` back-to-back calls, rotating
    over ``n_sets`` input sets (so a set is cold in L2 when its turn
    comes), by CUDA events. The stream is held while the host queues the
    calls (for twice the host's least time per call in warm-up, at most a
    second), so a call that costs the host more than the card (a one-token
    SSD chunk, a decode attention) is timed on the card, not on the host;
    a call that synchronises inside is timed on the host all the same."""
    host_ms = []
    for i in range(warmup):
        t0 = time.perf_counter()
        fn(i % n_sets)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    hold_stream(min(2 * min(host_ms) * reps + 5, 1000))
    e0.record()
    for i in range(reps):
        fn(i % n_sets)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def bound(bytes_moved, flops, dtype):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def free_card():
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 1: card and build
# ---------------------------------------------------------------------------

def phase_card_and_build():
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    log(f"device: {name}  count={count}  nvidia-smi: {smi_line}")
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "python", sys.version.split()[0])
    t0 = time.perf_counter()
    reports = _build.build()
    log(f"build: {sorted(reports)} in {time.perf_counter() - t0:.1f} s "
        f"(into {_build.BUILD_DIR.relative_to(ROOT)})")
    for src, text in reports.items():
        for line in text.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                log(f"  ptxas[{src}] {line.strip()[:200]}")
    return name, count, smi_line


# ---------------------------------------------------------------------------
# phase 2: kernels vs their plain versions
# ---------------------------------------------------------------------------

def check_flash(rng, dev, B, S, H, KH, hd, dt, Sk=None, win=0):
    Sk = Sk or S
    q = rand(rng, (B, S, H, hd), dt, dev)
    k = rand(rng, (B, Sk, KH, hd), dt, dev)
    v = rand(rng, (B, Sk, KH, hd), dt, dev)
    what = f"flash  B={B} S={S} Sk={Sk} H={H} KH={KH} hd={hd} win={win} " \
        f"{str(dt)[6:]}"
    e = check_close(what, flash_ops.flash_attention(q, k, v, window=win),
                    attn.reference_attention(q, k, v, window=win), TOLS[dt],
                    TOLS[dt])
    log(f"{what}: max abs err {e:.3e} (tol {TOLS[dt]})")
    return e


def ssd_inputs(rng, dev, B, S, nh, hp, ns, dtype):
    """tests/test_kernels.py's SSD distributions; x/B/C in ``dtype``."""
    x = rand(rng, (B, S, nh, hp), dtype, dev, 0.5)
    dt = F.softplus(rand(rng, (B, S, nh), torch.float32, dev))
    A_log = rand(rng, (nh,), torch.float32, dev, 0.3)
    Bm = rand(rng, (B, S, ns), dtype, dev, 0.5)
    Cm = rand(rng, (B, S, ns), dtype, dev, 0.5)
    return x, dt, A_log, Bm, Cm


def check_ssd_chunk(rng, dev, B, S, nh, hp, ns, cl, dtype=torch.float32):
    """Each piece against ssd_chunk_ref and, in bf16, against the split
    arithmetic of the tensor-core instance (ssd_chunk_split_ref)."""
    args = ssd_inputs(rng, dev, B, S, nh, hp, ns, dtype)
    out = ssd_kernel.ssd_chunk_call(*args, chunk=cl)
    names = ("y_diag", "states", "exp_cs", "exp_tot")
    refs = {"plain": ssd_chunk_ref(*args, chunk=cl)}
    if dtype == torch.bfloat16:
        refs["split"] = ssd_chunk_split_ref(*args, chunk=cl)
    errs = {what: [check_close(f"ssd chunk {(B, S, nh, hp, ns, cl)} {name} "
                               f"vs {what}", o, r, SSD_ATOL, SSD_RTOL)
                   for name, o, r in zip(names, out, ref)]
            for what, ref in refs.items()}
    e = errs["plain"]
    split = f"; vs split {max(errs['split']):.3e}" if "split" in errs else ""
    path = ssd_kernel.plan(B, S, nh, hp, ns, cl, dtype)["path"]
    log(f"ssd    B={B} S={S} nh={nh} hp={hp} ns={ns} cl={cl} "
        f"{str(dtype)[6:]} ({path}): max abs err y {e[0]:.3e} states "
        f"{e[1]:.3e} exp_cs {e[2]:.3e} exp_tot {e[3]:.3e}{split} (atol "
        f"{SSD_ATOL} rtol {SSD_RTOL})")
    return max(max(v) for v in errs.values())


def check_ssd_full(rng, dev, B, S, nh, hp, ns, cl, dtype=torch.float32,
                   state=False):
    x, dt, A_log, Bm, Cm = ssd_inputs(rng, dev, B, S, nh, hp, ns, dtype)
    D = torch.ones(nh, device=dev)
    st0 = rand(rng, (B, nh, hp, ns), torch.float32, dev, 0.2) if state \
        else None
    y, st = ssd_ops.ssd(x, dt, A_log, Bm, Cm, D, chunk=cl, state=st0)
    yr, sr = ssd_ref(x, dt, A_log, Bm, Cm, D, cl, state=st0)
    what = f"ssd    full B={B} S={S} nh={nh} hp={hp} ns={ns} cl={cl} " \
        f"{str(dtype)[6:]}{' +state' if state else ''}"
    # y comes back in x's dtype: a bf16 y is held at one bf16 rounding
    tol = (SSD_ATOL, SSD_RTOL) if dtype == torch.float32 else (TOLS[dtype],
                                                               TOLS[dtype])
    ey = check_close(what + " y", y, yr, *tol)
    es = check_close(what + " state", st, sr, SSD_ATOL, SSD_RTOL)
    log(f"{what} vs the plain chunked SSD: max abs err y {ey:.3e} (tol "
        f"{tol[0]}/{tol[1]}), state {es:.3e}")


def check_flash_strided(rng, dev):
    """q/k/v that are views into wider rows go through TMA by their
    strides; rows that are not 16-byte aligned are refused."""
    B, S, H, KH, hd, pad = 2, 96, 4, 2, 64, 8
    q, k, v = (rand(rng, (B, S, n, hd + pad), torch.bfloat16, dev)[..., :hd]
               for n in (H, KH, KH))
    e = check_close("flash strided", flash_kernel.flash_attention_fwd(q, k, v),
                    attn.reference_attention(q, k, v), TOLS[torch.bfloat16],
                    TOLS[torch.bfloat16])
    bad = torch.zeros((1, 64, 2, 68), dtype=torch.bfloat16,
                      device=dev)[..., :64]
    try:
        flash_kernel.flash_attention_fwd(bad, bad, bad)
    except ValueError:
        pass
    else:
        raise AssertionError("flash kernel took misaligned bf16 rows")
    log(f"flash  strided views (rows of {hd + pad}): max abs err {e:.3e}; "
        f"misaligned rows refused")


def check_flash_bwd(rng, dev, B, S, H, KH, hd, dt, win=0, q_chunk=64):
    """The forward's lse output against the plain forward's, then the
    backward kernel against the plain block-recompute backward on the
    same (q, k, v, o, lse, do). Returns the backward's max abs error."""
    q, do = (rand(rng, (B, S, H, hd), dt, dev) for _ in range(2))
    k, v = (rand(rng, (B, S, KH, hd), dt, dev) for _ in range(2))
    o, lse = flash_kernel.flash_attention_fwd(q, k, v, window=win,
                                              with_lse=True)
    if not torch.equal(o, flash_kernel.flash_attention_fwd(q, k, v,
                                                           window=win)):
        raise AssertionError("flash forward: writing lse changed the output")
    _, lse_ref = flash_attention_fwd_ref(q, k, v, window=win,
                                         q_chunk=q_chunk)
    what = f"flash bwd B={B} S={S} H={H} KH={KH} hd={hd} win={win} " \
        f"{str(dt)[6:]}"
    e_lse = check_close(what + " lse", lse, lse_ref, LSE_TOL, LSE_TOL)
    got = flash_kernel.flash_attention_bwd(q, k, v, o, lse, do, window=win)
    ref = flash_attention_bwd_ref(q, k, v, o, lse, do, window=win,
                                  q_chunk=q_chunk)
    errs = [check_close(f"{what} d{n}", a, b, TOLS[dt], TOLS[dt])
            for n, a, b in zip("qkv", got, ref)]
    again = flash_kernel.flash_attention_bwd(q, k, v, o, lse, do, window=win)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{what}: two calls gave different bits")
    log(f"{what}: max abs err lse {e_lse:.3e} (atol = rtol = {LSE_TOL}); "
        f"dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} (atol = rtol = "
        f"{TOLS[dt]}); a second call bit-identical")
    return max(errs)


def paged_split_ref(q, kp, vp, table, lens):
    n_split = paged_kernel.plan(table.shape[1], kp.shape[1],
                                q.shape[1] // kp.shape[2], q.shape[2],
                                q.dtype)["n_split"]
    return paged_attention_split_ref(q, kp, vp, table, lens, n_split=n_split)


def check_paged_permuted(rng, dev, B, H, KH, hd, page, nblk):
    """The same pages under a permuted table give the same bits; the kernel
    also agrees with the plain split-merge version."""
    dt = torch.float32 if hd == 16 else torch.bfloat16
    npool = B * nblk
    q = rand(rng, (B, H, hd), dt, dev)
    kp = rand(rng, (npool, page, KH, hd), dt, dev)
    vp = rand(rng, (npool, page, KH, hd), dt, dev)
    table = torch.arange(npool, dtype=torch.int32, device=dev).view(B, nblk)
    lens = torch.tensor([nblk * page - 5 * i for i in range(B)],
                        dtype=torch.int32, device=dev)
    perm = torch.from_numpy(rng.permutation(npool)).to(dev)
    inv = torch.argsort(perm).to(torch.int32)
    a = paged_kernel.paged_attention(q, kp, vp, table, lens)
    b = paged_kernel.paged_attention(q, kp[perm], vp[perm],
                                     inv[table.long()], lens)
    if not torch.equal(a, b):
        raise AssertionError(f"paged kernel {B, H, KH, hd, page, nblk}: "
                             f"permuted table changed the bits")
    tol = PAGED_TOL_F32 if dt == torch.float32 else TOLS[dt]
    e = check_close("paged vs split-merge plain", a,
                    paged_split_ref(q, kp, vp, table, lens), tol, tol)
    log(f"paged  B={B} H={H} KH={KH} hd={hd} page={page} nblk={nblk} "
        f"{str(dt)[6:]} {paged_kernel.plan(nblk, page, H // KH, hd, dt)}: "
        f"permuted table bit-identical; vs split-merge plain {e:.3e}")


def check_paged_decode_lengths(rng, dev):
    """Every length a serving decode step reads (513 .. 543: 33 and 34
    pages of 16), stablelm's shape, against both plain versions."""
    B, H, hd = BATCH, 32, 64
    q = rand(rng, (B, H, hd), torch.bfloat16, dev)
    n_pages = B * MAX_LEN // lm.PAGE_SIZE
    kp = rand(rng, (n_pages, lm.PAGE_SIZE, H, hd), torch.bfloat16, dev)
    vp = rand(rng, (n_pages, lm.PAGE_SIZE, H, hd), torch.bfloat16, dev)
    worst = 0.0
    for pos in range(PROMPT, MAX_LEN - 1):
        table, lens = lm.identity_pages(B, MAX_LEN, pos, 0, dev)
        out = paged_kernel.paged_attention(q, kp, vp, table, lens)
        tol = TOLS[torch.bfloat16]
        worst = max(worst, check_close(
            f"paged length {pos + 1}", out,
            paged_split_ref(q, kp, vp, table, lens), tol, tol),
            check_close(f"paged length {pos + 1} vs plain", out,
                        paged_ops.paged_attention_ref(q, kp, vp, table,
                                                      lens), tol, tol))
    log(f"paged  every decode length {PROMPT + 1}..{MAX_LEN - 1} (B={B} "
        f"H={H} hd={hd}): max abs err {worst:.3e} against both plain "
        f"versions")


def phase_kernels_vs_plain(dev):
    rng = np.random.default_rng(0)
    for B, S, H, KH, hd, win in FLASH_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            check_flash(rng, dev, B, S, H, KH, hd, dt, win=win)
    # ragged edges at the 64-row q tiles and the 64-key tiles,
    # cross-attention lengths (Sk != S) and a sliding window
    for S in (1, 63, 65, 127, 129, 513):
        check_flash(rng, dev, 2, S, 4, 2, 64, torch.bfloat16)
    for S, Sk, win in ((100, 160, 0), (160, 100, 0), (200, 200, 48)):
        check_flash(rng, dev, 2, S, 4, 2, 64, torch.bfloat16, Sk=Sk, win=win)
    # head_dim 80 (zamba2-2.7b's shared attention block): ragged S, a window
    for dt in (torch.float32, torch.bfloat16):
        check_flash(rng, dev, 2, 256, 4, 2, 80, dt)
        check_flash(rng, dev, 1, 200, 4, 4, 80, dt)            # ragged S
    check_flash(rng, dev, 2, 200, 4, 2, 80, torch.bfloat16, win=48)
    check_flash_strided(rng, dev)
    for B, S, H, KH, hd, win in FLASH_BWD_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            check_flash_bwd(rng, dev, B, S, H, KH, hd, dt, win=win)

    for B, H, KH, hd, page, nblk in PAGED_SHAPES:
        for dt, tol in ((torch.float32, PAGED_TOL_F32),
                        (torch.bfloat16, TOLS[torch.bfloat16])):
            npool = nblk * B + 4
            q = rand(rng, (B, H, hd), dt, dev)
            kp = rand(rng, (npool, page, KH, hd), dt, dev)
            vp = rand(rng, (npool, page, KH, hd), dt, dev)
            table = torch.from_numpy(rng.permutation(npool)[:B * nblk]
                                     .reshape(B, nblk).astype(np.int32)).to(dev)
            lens_np = rng.integers(1, nblk * page + 1, B).astype(np.int32)
            lens_np[0] = 0 if B > 1 else lens_np[0]    # one all-masked row
            lens = torch.from_numpy(lens_np).to(dev)
            out = paged_ops.paged_attention(q, kp, vp, table, lens)
            ref = paged_ops.paged_attention(q.cpu(), kp.cpu(), vp.cpu(),
                                            table.cpu(), lens.cpu())
            e = check_close(f"paged {B, H, KH, hd, page, nblk} {dt}", out,
                            ref.to(dev), tol, tol)
            log(f"paged  B={B} H={H} KH={KH} hd={hd} page={page} "
                f"nblk={nblk} lens={lens_np.tolist()} {str(dt)[6:]}: "
                f"max abs err {e:.3e} (tol {tol})")

    # the same pages under a permuted table: bit-identical, also where the
    # pages are split across a cluster (both serving shapes, and 11 pages,
    # not a multiple of the split)
    for shape in ((2, 4, 2, 16, 8, 4), (BATCH, 32, 32, 64, 16, 34),
                  (BATCH, 32, 32, 80, 16, 34), (2, 8, 2, 64, 16, 11)):
        check_paged_permuted(rng, dev, *shape)
    check_paged_decode_lengths(rng, dev)

    # the SSD chunk kernel: the sweep of tests/test_kernels.py, a chunk of
    # one token (each decode step), a ragged 64-row tile, bf16 inputs
    for shape in SSD_SHAPES:
        check_ssd_chunk(rng, dev, *shape)
    for dtype in (torch.float32, torch.bfloat16):
        check_ssd_chunk(rng, dev, 2, 6, 4, 16, 8, 1, dtype)   # 6 chunks of 1
    check_ssd_chunk(rng, dev, 1, 200, 4, 32, 16, 100, torch.bfloat16)
    check_ssd_chunk(rng, dev, 1, 64, 3, 12, 20, 32, torch.bfloat16)  # scalar
    # the tensor-core instance at every hp and ns of the serving
    # configurations and the tests
    for hp in (16, 32, 64):
        for ns in (8, 16, 32, 64, 128):
            check_ssd_chunk(rng, dev, 2, 256, 3, hp, ns, 128, torch.bfloat16)
    # the full SSD (padding, initial state, inter-chunk recurrence)
    for shape in SSD_SHAPES:
        check_ssd_full(rng, dev, *shape)
    check_ssd_full(rng, dev, 1, 64, 2, 16, 8, 32, state=True)
    check_ssd_full(rng, dev, 2, 100, 4, 32, 16, 32)            # padded S
    check_ssd_full(rng, dev, 2, 5, 4, 16, 8, 1, state=True)    # cl = 1

    # the serving shapes
    errs = {}
    Bm, Hm, hdm = BATCH, 32, 64
    q = rand(rng, (Bm, PROMPT, Hm, hdm), torch.bfloat16, dev)
    k = rand(rng, (Bm, PROMPT, Hm, hdm), torch.bfloat16, dev)
    v = rand(rng, (Bm, PROMPT, Hm, hdm), torch.bfloat16, dev)
    errs["flash_attention_fwd"] = check_close(
        "flash serving shape", flash_ops.flash_attention(q, k, v),
        attn.reference_attention(q, k, v), TOLS[torch.bfloat16],
        TOLS[torch.bfloat16])
    log(f"flash  serving shape q/k/v {tuple(q.shape)} bf16 causal: max abs "
        f"err {errs['flash_attention_fwd']:.3e}")
    check_flash(rng, dev, BATCH, PROMPT, 32, 32, 80, torch.bfloat16)
    per_seq = MAX_LEN // lm.PAGE_SIZE
    for hd in (hdm, 80):
        qd = rand(rng, (Bm, Hm, hd), torch.bfloat16, dev)
        pool_k = rand(rng, (Bm * per_seq, lm.PAGE_SIZE, Hm, hd),
                      torch.bfloat16, dev)
        pool_v = rand(rng, (Bm * per_seq, lm.PAGE_SIZE, Hm, hd),
                      torch.bfloat16, dev)
        table, lens = lm.identity_pages(Bm, MAX_LEN, MAX_LEN - 2, 0, dev)
        out = paged_ops.paged_attention(qd, pool_k, pool_v, table, lens)
        e = check_close(
            "paged serving shape", out,
            paged_ops.paged_attention(qd.cpu(), pool_k.cpu(), pool_v.cpu(),
                                      table.cpu(), lens.cpu()).to(dev),
            TOLS[torch.bfloat16], TOLS[torch.bfloat16])
        e_split = check_close(
            "paged serving shape vs split-merge plain", out,
            paged_split_ref(qd, pool_k, pool_v, table, lens),
            TOLS[torch.bfloat16], TOLS[torch.bfloat16])
        errs.setdefault("paged_attention", e)
        # fp32 at the same split, against the plain split-merge version at
        # the fp32 tolerance (a fault in the merge's order or weights
        # shows there); one row of length 0, one that leaves the last
        # split empty
        q32, k32, v32 = (t.float() for t in (qd, pool_k, pool_v))
        lens32 = torch.tensor([MAX_LEN - 1, 0, 30 * lm.PAGE_SIZE, 97],
                              dtype=torch.int32, device=dev)
        e32 = check_close(
            "paged serving shape fp32 vs split-merge plain",
            paged_kernel.paged_attention(q32, k32, v32, table, lens32),
            paged_split_ref(q32, k32, v32, table, lens32), PAGED_TOL_F32,
            PAGED_TOL_F32)
        log(f"paged  serving shape q {tuple(qd.shape)} pool "
            f"{tuple(pool_k.shape)} bf16, {table.shape[1]} pages, length "
            f"{int(lens[0])}: max abs err {e:.3e} (plain), {e_split:.3e} "
            f"(split-merge plain); fp32 lengths {lens32.tolist()} vs "
            f"split-merge plain {e32:.3e} (tol {PAGED_TOL_F32})")
    # zamba2-2.7b (nh 80, ns 64) and mamba2-130m (nh 24, ns 128): prefill
    # (cl 256) and a decode step (cl 1), bf16 x/B/C as the model makes them
    errs["ssd_chunk_call"] = check_ssd_chunk(rng, dev, BATCH, PROMPT, 80, 64,
                                             64, 256, torch.bfloat16)
    check_ssd_chunk(rng, dev, BATCH, PROMPT, 24, 64, 128, 256, torch.bfloat16)
    check_ssd_chunk(rng, dev, BATCH, 1, 80, 64, 64, 1, torch.bfloat16)
    check_ssd_chunk(rng, dev, BATCH, 1, 24, 64, 128, 1, torch.bfloat16)
    check_ssd_full(rng, dev, BATCH, PROMPT, 80, 64, 64, 256)
    check_ssd_full(rng, dev, BATCH, PROMPT, 24, 64, 128, 256)
    # the training shape: stablelm-1.6b's attention at 2 x 4096
    errs["flash_attention_bwd"] = check_flash_bwd(
        rng, dev, TRAIN_B, TRAIN_S, 32, 32, 64, torch.bfloat16, q_chunk=512)
    torch.cuda.synchronize()
    return errs


# ---------------------------------------------------------------------------
# phase 3: the main paths
# ---------------------------------------------------------------------------

def expected_launches(cfg):
    L, steps = cfg.n_layers, NEW - 1
    if cfg.family == "dense":
        return {"flash_attention_fwd": L, "flash_attention_bwd": 0,
                "paged_attention": L * steps, "ssd_chunk_call": 0}
    G = L // cfg.attn_every if cfg.family == "hybrid" else 0
    return {"flash_attention_fwd": G, "flash_attention_bwd": 0,
            "paged_attention": G * steps, "ssd_chunk_call": L * (1 + steps)}


def phase_main_path(dev, arch):
    cfg = get_config(arch)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, gen, device=dev)
    serve = ServeLoop(cfg, params, max_len=MAX_LEN, device=dev)
    del params
    free_card()
    n_par = sum(t.numel() for t in _leaves(serve.params))
    shape = (f"H={cfg.n_heads} KH={cfg.n_kv_heads} hd={cfg.hd} "
             f"d_ff={cfg.d_ff} " if cfg.family != "ssm" else "")
    if cfg.ssm is not None:
        s = cfg.ssm
        shape += (f"ssm heads={s.n_heads(cfg.d_model)} headdim={s.headdim} "
                  f"d_state={s.d_state} chunk={s.chunk} ")
    if cfg.family == "hybrid":
        shape += f"attn_every={cfg.attn_every} "
    log(f"main[{arch}]: {cfg.family} {cfg.n_layers}L d_model={cfg.d_model} "
        f"{shape}vocab={cfg.vocab_size}: {n_par / 1e9:.3f} B params, built "
        f"in {time.perf_counter() - t0:.1f} s")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)

    torch.cuda.synchronize()
    for fn in KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    toks = serve.generate(prompts, NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in KERNELS.items()}
    log(f"main[{arch}]: generate -> tokens {tuple(toks.shape)} in "
        f"{gen_s:.2f} s; launches {launches}")
    want = expected_launches(cfg)
    if launches != want:
        raise AssertionError(f"{arch}: launch counts {launches} != {want}")
    if tuple(toks.shape) != (BATCH, NEW) or \
            not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"{arch}: generated tokens out of range")

    with torch.inference_mode():
        tokens = torch.from_numpy(prompts).to(dev)
        logits0, cache = serve.prefill(serve.params, {"tokens": tokens})
        full = lm.grow_cache(cfg, cache, MAX_LEN)
        first = logits0[:, :cfg.vocab_size].argmax(-1).to(torch.int32)[:, None]
        step_logits, _ = lm.decode_step(cfg, serve.params, full, first, PROMPT)
        seq = torch.cat([tokens, first], dim=1)
        fwd_logits, _, _ = lm.forward(cfg, serve.params, {"tokens": seq})
        ref = fwd_logits[:, PROMPT]
        for what, t in (("prefill", logits0), ("decode", step_logits),
                        ("forward", ref)):
            if not bool(torch.isfinite(t.float()).all()):
                raise AssertionError(f"{arch}: {what} logits are not finite")
        V = cfg.vocab_size
        atol, rtol = LOGIT_TOLS[cfg.family]
        err = check_close(f"{arch}: first decode step vs forward",
                          step_logits[:, :V], ref[:, :V], atol, rtol)
        agree = (step_logits[:, :V].argmax(-1) == ref[:, :V].argmax(-1))
        same_first = bool(torch.equal(first[:, 0], toks[:, 0]))
        same_second = (step_logits[:, :V].argmax(-1).to(torch.int32)
                       == toks[:, 1])
        del fwd_logits, full, cache
    log(f"main[{arch}]: first decode step vs forward over prompt+token: max "
        f"abs err {err:.3e} (|ref| max {ref.float().abs().max().item():.3f}; "
        f"atol {atol} rtol {rtol}); greedy agreement "
        f"{int(agree.sum())}/{BATCH}; generate's token 0 reproduced: "
        f"{same_first}, token 1: {int(same_second.sum())}/{BATCH}")
    return cfg, serve, prompts, launches


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def train_loader(corpus):
    return RingLoader(TokenStore(corpus), batch=TRAIN_B, seq=TRAIN_S)


def card_batch(corpus, dev):
    return {k: torch.as_tensor(v, device=dev)
            for k, v in next(iter(train_loader(corpus))).items()}


def phase_train(dev, corpus, ckpt_dir):
    """TrainLoop on stablelm-1.6b at full width and full depth: the
    counters, set to 0 just before ``run()`` and read just after, must
    show 48 forward (remat runs each layer's forward twice) and 24
    backward flash launches a step; the loss stays finite, the gradient
    is nonzero and the parameters move."""
    cfg = get_config(TRAIN_ARCH)
    if not cfg.remat:
        raise AssertionError(f"{TRAIN_ARCH}: expected remat in its config")
    t0 = time.perf_counter()
    loop = TrainLoop(cfg, TrainLoopConfig(total_steps=TRAIN_STEPS,
                                          ckpt_every=TRAIN_STEPS + 1,
                                          ckpt_dir=ckpt_dir, log_every=1),
                     train_loader(corpus), seed=0, device=dev)
    n_par = sum(t.numel() for t in tree_leaves(loop.params))
    lay = loop.params["layers"]
    watch = {"embed": loop.params["embed"][:256], "wq[0]": lay["attn"]["wq"][0],
             "w2[23]": lay["mlp"]["w2"][-1],
             "final_norm": loop.params["final_norm"]}
    before = {n: t.detach().clone() for n, t in watch.items()}
    log(f"train[{TRAIN_ARCH}]: {cfg.n_layers}L d_model={cfg.d_model} "
        f"H={cfg.n_heads} hd={cfg.hd} d_ff={cfg.d_ff} vocab="
        f"{cfg.vocab_size}: {n_par / 1e9:.3f} B params fp32, AdamW m/v "
        f"fp32, remat={cfg.remat}, bf16 compute; batch {TRAIN_B} x "
        f"{TRAIN_S} tokens; built in {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    loop.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in KERNELS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for m in loop.metrics_log:
        log(f"train[{TRAIN_ARCH}]: step {m['step']}: loss {m['loss']:.6f} "
            f"grad_norm {m['grad_norm']:.6f} lr {m['lr']:.3e}")
    log(f"train[{TRAIN_ARCH}]: {TRAIN_STEPS} steps in {run_s:.2f} s "
        f"(first step included); launches {launches}; peak memory "
        f"{peak_gb:.2f} GB")
    L = cfg.n_layers
    want = {"flash_attention_fwd": 2 * L * TRAIN_STEPS,
            "flash_attention_bwd": L * TRAIN_STEPS, "paged_attention": 0,
            "ssd_chunk_call": 0}
    if launches != want:
        raise AssertionError(f"train: launch counts {launches} != {want}")
    if len(loop.metrics_log) != TRAIN_STEPS or not all(
            np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
            for m in loop.metrics_log):
        raise AssertionError(f"train: non-finite metrics {loop.metrics_log}")
    if not all(m["grad_norm"] > 0 for m in loop.metrics_log):
        raise AssertionError("train: a zero gradient")
    moved = {n: float((watch[n].float() - before[n].float()).abs().max())
             for n in watch}
    if not all(v > 0 for v in moved.values()):
        raise AssertionError(f"train: parameters did not move: {moved}")
    log(f"train[{TRAIN_ARCH}]: largest change of watched parameters over "
        f"the run: { {n: f'{v:.3e}' for n, v in moved.items()} }")
    return cfg, loop, launches, peak_gb


def phase_train_times(dev, cfg, loop, corpus):
    """The train step's device and host time after the run's warm-up,
    tokens/s, and where its time goes (torch.profiler over one step:
    forward + backward, then the optimizer)."""
    batch = card_batch(corpus, dev)
    reps = 3
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    for _ in range(reps):
        loop.params, loop.opt_state, m = loop.step_fn(loop.params,
                                                      loop.opt_state, batch)
    e1.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    step_ms = e0.elapsed_time(e1) / reps
    tok_s = TRAIN_B * TRAIN_S * 1e3 / host_ms
    log(f"train[{TRAIN_ARCH}]: step {step_ms:.3f} ms by CUDA events "
        f"({host_ms:.3f} ms host, mean of {reps}), {tok_s:.1f} tokens/s at "
        f"batch {TRAIN_B} x {TRAIN_S}; loss {float(m['loss']):.6f}")

    box = {}

    def fwd_bwd():
        box["lg"] = loss_and_grads(cfg, loop.params, batch)

    def optimizer():
        lr = cosine_schedule(loop.opt_state.step, peak_lr=loop.lc.peak_lr,
                             warmup=100, total=loop.lc.total_steps)
        loop.params, loop.opt_state, _ = adamw_update(
            box["lg"][1], loop.opt_state, loop.params, lr=lr)
    log(f"where the time goes [{TRAIN_PATH}] (torch.profiler, one step):")
    wall, kern, host = _profile(fwd_bwd)
    _report("forward + backward", wall, kern, host)
    wall_o, kern_o, host_o = _profile(optimizer)
    _report("optimizer (AdamW)", wall_o, kern_o, host_o)
    busy = sum(us for us, _ in kern.values()) / 1e3
    busy_o = sum(us for us, _ in kern_o.values()) / 1e3
    log(f"  train step: wall {wall + wall_o:.3f} ms, device busy "
        f"{busy + busy_o:.3f} ms ({100 * (busy + busy_o) / (wall + wall_o):.1f}"
        f"%), optimizer {busy_o:.3f} ms of it")
    del box
    return {"step_ms": step_ms, "step_host_ms": host_ms,
            "tokens_per_s": tok_s}


def _plain_flash(q, k, v, *, causal=True, window=0, q_chunk=512, k_chunk=0,
                 scale=None, schedule="triangular"):
    return attn.reference_attention(q, k, v, causal=causal, window=window,
                                    scale=scale)


def phase_train_grads(dev, corpus):
    """One step's loss and every gradient leaf at full width and 2 layers,
    with the flash kernels, against the same step with attention through
    autograd of the plain ``reference_attention`` (bf16 compute both)."""
    cfg = get_config(TRAIN_ARCH).replace(n_layers=2)
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(1),
                            device=dev)
    batch = card_batch(corpus, dev)
    for fn in KERNELS.values():
        fn.launches = 0
    loss_k, grads_k = loss_and_grads(cfg, params, batch)
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in KERNELS.items()}
    kernel_attention = attn.flash_attention
    attn.flash_attention = _plain_flash
    try:
        loss_p, grads_p = loss_and_grads(cfg, params, batch)
        torch.cuda.synchronize()
    finally:
        attn.flash_attention = kernel_attention
    want = {"flash_attention_fwd": (2 if cfg.remat else 1) * cfg.n_layers,
            "flash_attention_bwd": cfg.n_layers, "paged_attention": 0,
            "ssd_chunk_call": 0}
    if launches != want:
        raise AssertionError(f"2-layer step launches {launches} != {want}")
    if any(fn.launches != launches[n] for n, fn in KERNELS.items()):
        raise AssertionError("the plain step launched a kernel")
    loss_err = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    if not loss_err <= GRAD_LOSS_RTOL:
        raise AssertionError(f"2-layer loss {float(loss_k)} vs plain "
                             f"{float(loss_p)}: {loss_err:.3e}")
    worst = ("", 0.0)
    names = [n for n, _ in _named_leaves(grads_k)]
    for name, a, b in zip(names, tree_leaves(grads_k), tree_leaves(grads_p)):
        rel = float((a.float() - b.float()).norm() / b.float().norm())
        if not (np.isfinite(rel) and rel <= GRAD_REL_L2):
            raise AssertionError(f"2-layer gradient {name}: relative L2 "
                                 f"{rel:.3e} > {GRAD_REL_L2}")
        worst = max(worst, (name, rel), key=lambda x: x[1])
    log(f"train[{TRAIN_ARCH}, 2 layers]: flash kernels vs autograd of the "
        f"plain attention, one step at {TRAIN_B} x {TRAIN_S}: loss "
        f"{float(loss_k):.6f} vs {float(loss_p):.6f} (rel {loss_err:.2e}, "
        f"tol {GRAD_LOSS_RTOL}); {len(names)} gradient leaves, worst "
        f"relative L2 {worst[1]:.3e} at {worst[0]} (tol {GRAD_REL_L2})")
    return worst[1]


def _named_leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _named_leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def phase_train_restart(dev, ckpt_dir):
    """Twin of test_substrate.py::test_train_restart_matches_uninterrupted
    on the card at smoke size (head_dim 32): crash at step 8, restart from
    the port's ring checkpoint of step 5, and the final parameters are
    bitwise those of the uninterrupted run."""
    cfg = get_smoke_config(TRAIN_ARCH).replace(head_dim=32)
    params0 = lm.init_params(cfg, torch.Generator(dev).manual_seed(0),
                             device=dev)
    step_fn = make_train_step(cfg, peak_lr=1e-2, warmup=2)
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(RESTART_STEPS):
        t = rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
        batches.append({"tokens": torch.from_numpy(t).to(dev),
                        "labels": torch.from_numpy(np.roll(t, -1, 1)).to(dev)})
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            p = tree_map(lambda t: t.clone(), params0)
            o = adamw_init(p)
            for i in range(RESTART_STEPS):
                p, o, _ = step_fn(p, o, batches[i])
            ref = p
            ck = Checkpointer(ckpt_dir, every=RESTART_CKPT)
            p = tree_map(lambda t: t.clone(), params0)
            o = adamw_init(p)
            for i in range(RESTART_CRASH):
                ck.maybe_save(i, {"p": p, "o": o})
                p, o, _ = step_fn(p, o, batches[i])
            restored, st = ck.restore_or({"p": p, "o": o})
            p, o = restored["p"], restored["o"]
            if st != RESTART_CKPT or int(o.step) != RESTART_CKPT:
                raise AssertionError(f"restart: restored step {st}, "
                                     f"optimizer step {int(o.step)}")
            for i in range(st, RESTART_STEPS):
                p, o, _ = step_fn(p, o, batches[i])
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    nondet = sorted({str(w.message).split(" does not have")[0]
                     for w in caught if "deterministic" in str(w.message)})
    differ = [n for (n, a), b in zip(_named_leaves(ref), tree_leaves(p))
              if not torch.equal(a, b)]
    if differ:
        raise AssertionError(f"restart: {len(differ)} parameter leaves "
                             f"differ from the uninterrupted run: {differ}; "
                             f"ops without a deterministic CUDA version: "
                             f"{nondet}")
    log(f"train restart [{TRAIN_ARCH} smoke, hd 32]: crash at step "
        f"{RESTART_CRASH}, restart from the ring checkpoint of step {st}: "
        f"all {len(tree_leaves(p))} parameter leaves bitwise equal to the "
        f"uninterrupted {RESTART_STEPS} steps under "
        f"use_deterministic_algorithms; ops without a deterministic CUDA "
        f"version on the path: {nondet or 'none'}")


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------

def ssd_work(B, S, nh, hp, ns, cl, esz):
    """(bytes, flops) of one ssd_chunk_call: each input read once, each
    output written once; C B^T once per chunk and the products only on the
    lower triangle (FMA = 2), plus the elementwise x·dt, L (sub, exp, mul)
    and decay weights."""
    nc = S // cl
    tri = cl * (cl + 1) // 2
    byt = (B * S * nh * hp * esz + B * S * nh * 4 + nh * 4
           + 2 * B * S * ns * esz                       # x, dt, A_log, B, C
           + B * S * nh * hp * 4 + B * nc * nh * hp * ns * 4
           + B * S * nh * 4 + B * nc * nh * 4)          # y, states, exps
    flops = (2 * B * nc * tri * ns + 2 * B * nc * nh * tri * hp
             + 3 * B * nc * nh * tri + 2 * B * S * nh * hp * ns
             + 2 * B * S * nh * hp + 2 * B * S * nh)
    return byt, flops


def time_flash(rng, dev, H, KH, hd, B=BATCH, S=PROMPT, with_lse=False):
    """Device ms of the bf16 kernel (writing lse, as training calls it,
    with ``with_lse``), its plain version, SDPA and the bound."""
    dt = torch.bfloat16
    sets = [tuple(rand(rng, (B, S, n, hd), dt, dev) for n in (H, KH, KH))
            for _ in range(4)]                       # 4 x >= 33.5 MB > L2
    reps = max(5, 50 * PROMPT * PROMPT // (S * S))
    ms = cuda_ms(lambda i: flash_kernel.flash_attention_fwd(
        *sets[i], with_lse=with_lse), 4, reps)
    plain_ms = cuda_ms(lambda i: attn.reference_attention(*sets[i]), 4,
                       max(3, reps // 5))
    t_sets = [tuple(t.transpose(1, 2).contiguous() for t in s) for s in sets]
    lib_ms = cuda_ms(
        lambda i: F.scaled_dot_product_attention(*t_sets[i], is_causal=True),
        4, reps)
    pairs = S * (S + 1) // 2
    bnd = bound(2 * B * S * H * hd * 2 + 2 * B * S * KH * hd * 2
                + (B * H * S * 4 if with_lse else 0),
                4 * B * H * hd * pairs, dt)
    log(f"  flash  q/k/v {(B, S, H, hd)} bf16 causal"
        f"{' (+lse)' if with_lse else ''}: kernel {ms:.4f} ms "
        f"({flash_kernel.plan(hd)}), plain {plain_ms:.4f} ms, sdpa "
        f"{lib_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
    return ms, plain_ms, lib_ms, bnd


def time_flash_bwd(rng, dev, B=TRAIN_B, S=TRAIN_S, H=32, hd=64):
    """Device ms of the backward kernel at the training shape (causal,
    bf16), its plain version, the backward of SDPA (causal) and the
    bound: q/k/v/o/do and lse read once, dq/dk/dv written once; five
    products over the causal pairs."""
    dt = torch.bfloat16
    sets = []
    for _ in range(2):                               # 2 x 168 MB > L2
        q, k, v, do = (rand(rng, (B, S, H, hd), dt, dev) for _ in range(4))
        o, lse = flash_kernel.flash_attention_fwd(q, k, v, with_lse=True)
        sets.append((q, k, v, o, lse, do))
    ms = cuda_ms(lambda i: flash_kernel.flash_attention_bwd(*sets[i]), 2, 5,
                 warmup=2)
    plain_ms = cuda_ms(lambda i: flash_attention_bwd_ref(*sets[i]), 2, 2,
                       warmup=1)
    lib = []
    for q, k, v, _, _, do in sets:
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        lib.append((out, (qt, kt, vt), do.transpose(1, 2).contiguous()))
    lib_ms = cuda_ms(lambda i: torch.autograd.grad(
        lib[i][0], lib[i][1], lib[i][2], retain_graph=True), 2, 10)
    pairs = S * (S + 1) // 2
    bnd = bound(8 * B * S * H * hd * 2 + B * H * S * 4,
                5 * 2 * B * H * hd * pairs, dt)
    log(f"  flash bwd q/k/v/o/do {(B, S, H, hd)} bf16 causal: kernel "
        f"{ms:.4f} ms ({5 * 2 * B * H * hd * pairs / ms / 1e9:.1f} TFLOP/s "
        f"of the five products), plain {plain_ms:.4f} ms, backward of sdpa "
        f"{lib_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
    del lib
    return ms, plain_ms, lib_ms, bnd


def time_paged(rng, dev, H, KH, hd, length):
    """Device ms at one decode length (the split depends on the pages)."""
    dt = torch.bfloat16
    B = BATCH
    per_seq = MAX_LEN // lm.PAGE_SIZE
    table, lens = lm.identity_pages(B, MAX_LEN, length - 1, 0, dev)
    q = rand(rng, (B, H, hd), dt, dev)
    pools = [tuple(rand(rng, (B * per_seq, lm.PAGE_SIZE, KH, hd), dt, dev)
                   for _ in range(2)) for _ in range(8)]   # 8 x 17.8 MB
    ms = cuda_ms(lambda i: paged_kernel.paged_attention(
        q, *pools[i], table, lens), 8, 200)
    plain_ms = cuda_ms(lambda i: paged_ops.paged_attention_ref(
        q, *pools[i], table, lens), 8, 20)
    # one PyTorch call for the same function: the identity table reads a
    # dense cache, so the single query over that cache, (B,H,1,hd) x
    # (B,KH,L,hd) in the layout SDPA takes (laid out beforehand)
    dense = [tuple(p.view(B, per_seq * lm.PAGE_SIZE, KH, hd)[:, :length]
                   .transpose(1, 2).contiguous() for p in ps) for ps in pools]
    q4 = q[:, :, None, :]
    gqa = dict(enable_gqa=True) if KH != H else {}
    ref = paged_kernel.paged_attention(q, *pools[0], table, lens)
    lib = F.scaled_dot_product_attention(q4, *dense[0], **gqa)[:, :, 0]
    check_close("sdpa vs paged kernel", lib, ref, TOLS[dt], TOLS[dt])
    lib_ms = cuda_ms(lambda i: F.scaled_dot_product_attention(
        q4, *dense[i], **gqa), 8, 200)
    bnd = bound(2 * B * length * KH * hd * 2 + 2 * B * H * hd * 2
                + table.numel() * 4 + lens.numel() * 4,
                4 * B * H * hd * length, dt)
    plan = paged_kernel.plan(table.shape[1], lm.PAGE_SIZE, H // KH, hd, dt)
    log(f"  paged  q {(B, H, hd)} over {table.shape[1]} pages x "
        f"{lm.PAGE_SIZE}, length {length}, clusters of {plan['n_split']} "
        f"CTAs x {plan['pages_per_split']} pages ({plan['pages_per_stage']} "
        f"a stage, {plan['smem_bytes']} B shared), grid "
        f"{plan['n_split'] * KH * B} CTAs, {KH * B} clusters of which "
        f"{plan['max_active_clusters']} fit at once: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa over the dense cache {lib_ms:.4f} ms, "
        f"bound {bnd[0]:.4f} ms ({bnd[1]})")
    return ms, plain_ms, lib_ms, bnd


def time_ssd(rng, dev, nh, hp, ns, S, cl, what):
    dt = torch.bfloat16
    B = BATCH
    n_sets = 4
    sets = [ssd_inputs(rng, dev, B, S, nh, hp, ns, dt) for _ in range(n_sets)]
    reps = 50 if S > 1 else 500
    ms = cuda_ms(lambda i: ssd_kernel.ssd_chunk_call(*sets[i], chunk=cl),
                 n_sets, reps)
    plain_ms = cuda_ms(lambda i: ssd_chunk_ref(*sets[i], chunk=cl), n_sets,
                       max(5, reps // 10))
    byt, flops = ssd_work(B, S, nh, hp, ns, cl, 2)
    t_bytes, t_ops = byt / PEAK_BYTES_PER_S, flops / SSD_RATE[1]
    bnd = (max(t_bytes, t_ops) * 1e3,
           "bytes" if t_bytes >= t_ops else "operations")
    log(f"  ssd    {what}: x {(B, S, nh, hp)} ns {ns} cl {cl} bf16: kernel "
        f"{ms:.4f} ms ({ssd_kernel.plan(B, S, nh, hp, ns, cl, dt)}), plain "
        f"{plain_ms:.4f} ms, library none, bound {bnd[0]:.4f} ms ({bnd[1]}; "
        f"{byt / 1e6:.1f} MB at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s, "
        f"{flops / 1e9:.3f} GFLOP at the {SSD_RATE[0]}' "
        f"{SSD_RATE[1] / 1e12:.0f} TFLOP/s)")
    return ms, plain_ms, None, bnd


def phase_kernel_times(dev):
    rng = np.random.default_rng(1)
    log("kernel times at the serving and training shapes (device ms a "
        "call: CUDA events over back-to-back calls queued behind a held "
        "stream):")
    out = {"flash_attention_fwd": time_flash(rng, dev, 32, 32, 64)}
    time_flash(rng, dev, 32, 32, 80)                  # zamba2-2.7b
    out["flash_attention_fwd train"] = time_flash(
        rng, dev, 32, 32, 64, B=TRAIN_B, S=TRAIN_S, with_lse=True)
    free_card()
    out["flash_attention_bwd"] = time_flash_bwd(rng, dev)
    free_card()
    # the first and last decode steps' lengths: 33 and 34 pages
    time_paged(rng, dev, 32, 32, 64, PROMPT + 1)
    out["paged_attention"] = time_paged(rng, dev, 32, 32, 64, MAX_LEN - 1)
    time_paged(rng, dev, 32, 32, 80, PROMPT + 1)      # zamba2-2.7b
    time_paged(rng, dev, 32, 32, 80, MAX_LEN - 1)
    free_card()
    out["ssd_chunk_call"] = time_ssd(rng, dev, 80, 64, 64, PROMPT, 256,
                                     "zamba2-2.7b prefill")
    time_ssd(rng, dev, 24, 64, 128, PROMPT, 256, "mamba2-130m prefill")
    time_ssd(rng, dev, 80, 64, 64, 1, 1, "zamba2-2.7b decode step")
    time_ssd(rng, dev, 24, 64, 128, 1, 1, "mamba2-130m decode step")
    free_card()
    return out


def phase_serve_times(dev, arch, cfg, serve, prompts):
    with torch.inference_mode():
        tokens = torch.from_numpy(prompts).to(dev)
        batch = {"tokens": tokens}
        serve.prefill(serve.params, batch)
        torch.cuda.synchronize()
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            logits0, cache = serve.prefill(serve.params, batch)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3 / reps
        full = lm.grow_cache(cfg, cache, MAX_LEN)
        del cache
        nxt = logits0[:, :cfg.vocab_size].argmax(-1).to(torch.int32)[:, None]
        serve.step(serve.params, full, nxt, PROMPT)       # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        for pos in range(PROMPT, PROMPT + NEW - 1):
            nxt, full = serve.step(serve.params, full, nxt, pos)
        e1.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / (NEW - 1)
        decode_ms = e0.elapsed_time(e1) / (NEW - 1)
        del full
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"serve[{arch}]: prefill {BATCH}x{PROMPT}: {prefill_ms:.3f} ms (host "
        f"clock, synchronized, mean of {reps}); decode: {decode_ms:.3f} "
        f"ms/step by CUDA events ({host_ms:.3f} ms host), "
        f"{BATCH * 1e3 / decode_ms:.1f} tokens/s at batch {BATCH}; peak "
        f"memory {peak_gb:.2f} GB")
    return {"prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms}


# ---------------------------------------------------------------------------
# phase 5: where the time goes (torch.profiler)
# ---------------------------------------------------------------------------

KINDS = (("flash fwd", ("flash_fwd_",)),
         ("flash bwd", ("flash_bwd_",)),
         ("paged kernel", ("paged_split_kernel",)),
         ("ssd kernel", ("ssd_chunk_kernel", "ssd_chunk_mma_kernel",
                         "ssd_decode_kernel")),
         ("gemm", ("gemm", "xmma", "nvjet", "cutlass", "cublas")),
         ("copy/cast", ("copy", "convert", "to_copy")),
         ("elementwise", ("elementwise",)),
         ("reduction", ("reduce",)))


def _kind(name):
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def _profile(fn):
    """Host wall ms of ``fn``, its device kernels (name -> (us, n)) and the
    host operators by self CPU time (name -> (us, n))."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us, n = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    if not kernels:
        raise AssertionError("torch.profiler recorded no device kernels")
    host = {e.key: (e.self_cpu_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU}
    return wall_ms, kernels, host


def _report(what, wall_ms, kernels, host, steps=1):
    busy_ms = sum(us for us, _ in kernels.values()) / 1e3
    by_kind = {}
    for name, (us, n) in kernels.items():
        by_kind[_kind(name)] = by_kind.get(_kind(name), 0.0) + us / 1e3
    kinds = ", ".join(f"{k} {v / steps:.3f}" for k, v in
                      sorted(by_kind.items(), key=lambda kv: -kv[1]))
    log(f"  {what}: wall {wall_ms / steps:.3f} ms, device busy "
        f"{busy_ms / steps:.3f} ms ({100 * busy_ms / wall_ms:.1f}%; idle "
        f"{100 * (1 - busy_ms / wall_ms):.1f}%), launches "
        f"{sum(n for _, n in kernels.values()) // steps}; by kind (ms): "
        f"{kinds}")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:6]
    for name, (us, n) in top:
        log(f"    {us / 1e3 / steps:8.3f} ms  x{n // steps:<4d} {name[:110]}")
    host_ms = sum(us for us, _ in host.values()) / 1e3
    log(f"    host operators, self CPU {host_ms / steps:.3f} ms; top:")
    for name, (us, n) in sorted(host.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"    {us / 1e3 / steps:8.3f} ms  x{n // steps:<4d} {name[:60]}")


def phase_profile(dev, arch, cfg, serve, prompts):
    steps = 8
    with torch.inference_mode():
        batch = {"tokens": torch.from_numpy(prompts).to(dev)}
        box = {}

        def prefill():
            box["out"] = serve.prefill(serve.params, batch)
        wall, kern, host = _profile(prefill)
        log(f"where the time goes [{arch}] (torch.profiler, per call):")
        _report(f"prefill {tuple(prompts.shape)}", wall, kern, host)
        logits0, cache = box.pop("out")
        full = lm.grow_cache(cfg, cache, MAX_LEN)
        del cache
        nxt = logits0[:, :cfg.vocab_size].argmax(-1).to(torch.int32)[:, None]

        def decode():
            t = nxt
            for pos in range(PROMPT, PROMPT + steps):
                t, _ = serve.step(serve.params, full, t, pos)
        wall, kern, host = _profile(decode)
        _report(f"decode step (mean of {steps})", wall, kern, host, steps)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    name, count, smi_line = phase_card_and_build()
    errs = phase_kernels_vs_plain(dev)
    free_card()
    launches, serve_times = {}, {}
    for arch in ARCHS:
        cfg, serve, prompts, launches[arch] = phase_main_path(dev, arch)
        serve_times[arch] = phase_serve_times(dev, arch, cfg, serve, prompts)
        phase_profile(dev, arch, cfg, serve, prompts)
        del serve
        free_card()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        cfg = get_config(TRAIN_ARCH)
        corpus = make_synthetic_corpus(
            os.path.join(tmp, "tokens.bin"), 64 * TRAIN_B * (TRAIN_S + 1),
            cfg.vocab_size, seed=0)
        cfg, loop, launches[TRAIN_PATH], train_peak_gb = phase_train(
            dev, corpus, os.path.join(tmp, "ckpt_full"))
        train_times = phase_train_times(dev, cfg, loop, corpus)
        train_times["peak_memory_gb"] = train_peak_gb
        del loop
        free_card()
        train_times["grad_rel_l2_2_layers"] = phase_train_grads(dev, corpus)
        free_card()
        phase_train_restart(dev, os.path.join(tmp, "ckpt_restart"))
        free_card()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    times = phase_kernel_times(dev)
    paths = ARCHS + (TRAIN_PATH,)
    kernels = []
    for kname, src, replaces in (
            ("flash_attention_fwd", "src/repro_torch/csrc/flash_fwd.cu",
             "src/repro/kernels/flash_attention/kernel.py:71"),
            ("flash_attention_bwd", "src/repro_torch/csrc/flash_bwd.cu",
             "src/repro/models/attention.py:211"),
            ("paged_attention", "src/repro_torch/csrc/paged_attn.cu",
             "src/repro/kernels/paged_attn/kernel.py:70"),
            ("ssd_chunk_call", "src/repro_torch/csrc/ssd_chunk.cu",
             "src/repro/kernels/ssd_scan/kernel.py:73")):
        ms, plain_ms, lib_ms, (bound_ms, bound_by) = times[kname]
        by_path = {a: launches[a][kname] for a in paths}
        entry = {"name": kname, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": sum(by_path.values()),
                 "launches_by_path": by_path, "max_abs_err": errs[kname],
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": lib_ms}
        if kname == "flash_attention_fwd":      # also at the training shape
            t_ms, t_plain, t_lib, (t_bound, _) = \
                times["flash_attention_fwd train"]
            entry.update(train_ms=t_ms, train_plain_ms=t_plain,
                         train_library_ms=t_lib, train_bound_ms=t_bound)
        kernels.append(entry)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels, "serve": serve_times,
                      "train": train_times}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
