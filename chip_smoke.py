#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root, on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits nonzero):

1. the card's name, count and power limit; build both CUDA kernels from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, in parallel) and
   print the compiler's register / shared-memory / spill report;
2. each kernel against its plain PyTorch version on CUDA tensors: the
   shape sweeps of ``tests/test_kernels.py``, a zero-length decode row, a
   permuted page table (bit-identical output) and the serving shapes;
3. the main path: ``stablelm-1.6b`` at full width (24 layers, d_model
   2048, vocab 100352; random weights from a seeded CUDA generator, bf16
   compute) serves 4 prompts of 512 tokens for 32 new tokens through
   ``ServeLoop.generate``; the launch counters show that prefill ran the
   flash kernel in every layer and each decode step the paged kernel in
   every layer; the first decode step's logits are held against a full
   forward over prompt + token;
4. times (CUDA events, after warm-up) of each kernel, its plain version
   and, for flash, ``scaled_dot_product_attention`` as a yardstick the
   port never calls, at the serving shapes; prefill and decode times;
5. where the time goes: ``torch.profiler`` over one prefill and eight
   decode steps, device busy share and kernel time by kind.

The last lines are a JSON object with one entry per kernel, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
Without a CUDA device the script prints no result and exits 2.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch                                                  # noqa: E402
import torch.nn.functional as F                               # noqa: E402

from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.kernels import _build                        # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash_kernel  # noqa
from repro_torch.kernels.flash_attention import ops as flash_ops        # noqa
from repro_torch.kernels.paged_attn import kernel as paged_kernel       # noqa
from repro_torch.kernels.paged_attn import ops as paged_ops             # noqa
from repro_torch.models import attention as attn               # noqa: E402
from repro_torch.models import lm                              # noqa: E402
from repro_torch.serve import ServeLoop                        # noqa: E402

# NVIDIA H100 SXM data sheet (dense, no sparsity), at the 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

TOLS = {torch.float32: 2e-5, torch.bfloat16: 2e-2}     # tests/test_kernels.py
PAGED_TOL_F32 = 3e-5
FLASH_SHAPES = [(2, 256, 4, 2, 64, 0), (1, 512, 4, 1, 128, 0),
                (2, 128, 8, 8, 32, 64), (1, 256, 2, 2, 64, 128)]
PAGED_SHAPES = [(2, 4, 2, 64, 32, 4), (3, 8, 2, 64, 16, 8),
                (1, 4, 4, 128, 64, 2)]

# the serving run: stablelm-1.6b, 4 prompts x 512 tokens, 32 new tokens
ARCH, BATCH, PROMPT, NEW, MAX_LEN = "stablelm-1.6b", 4, 512, 32, 544
# first decode step vs a full forward, both bf16 compute through 24
# layers (different GEMM shapes, flash vs paged attention): logits agree
# to within bf16 rounding carried through the layers
LOGIT_ATOL, LOGIT_RTOL = 0.15, 0.05


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


def cuda_ms(fn, n_sets, reps, warmup=3):
    """Mean ms per call over ``reps`` calls, rotating over ``n_sets`` input
    sets (so a set is cold in L2 when its turn comes), by CUDA events."""
    for i in range(warmup):
        fn(i % n_sets)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
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

def phase_kernels_vs_plain(dev):
    rng = np.random.default_rng(0)
    for B, S, H, KH, hd, win in FLASH_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            q = rand(rng, (B, S, H, hd), dt, dev)
            k = rand(rng, (B, S, KH, hd), dt, dev)
            v = rand(rng, (B, S, KH, hd), dt, dev)
            out = flash_ops.flash_attention(q, k, v, window=win)
            ref = attn.reference_attention(q, k, v, window=win)
            e = check_close(f"flash {B, S, H, KH, hd, win} {dt}", out, ref,
                            TOLS[dt], TOLS[dt])
            log(f"flash  B={B} S={S} H={H} KH={KH} hd={hd} win={win} "
                f"{str(dt)[6:]}: max abs err {e:.3e} (tol {TOLS[dt]})")
    # ragged edges (S not a multiple of the 64-row tile), cross-attention
    # lengths and a sliding window
    for S, Sk, win in ((513, 513, 0), (100, 160, 0), (200, 200, 48)):
        q = rand(rng, (2, S, 4, 64), torch.bfloat16, dev)
        k = rand(rng, (2, Sk, 2, 64), torch.bfloat16, dev)
        v = rand(rng, (2, Sk, 2, 64), torch.bfloat16, dev)
        e = check_close(f"flash ragged S={S} Sk={Sk} win={win}",
                        flash_ops.flash_attention(q, k, v, window=win),
                        attn.reference_attention(q, k, v, window=win),
                        TOLS[torch.bfloat16], TOLS[torch.bfloat16])
        log(f"flash  ragged S={S} Sk={Sk} win={win} bf16: max abs err "
            f"{e:.3e}")

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

    # the same pages under a permuted table: bit-identical
    B, H, KH, hd, page, nblk = 2, 4, 2, 16, 8, 4
    npool = B * nblk
    q = rand(rng, (B, H, hd), torch.float32, dev)
    kp = rand(rng, (npool, page, KH, hd), torch.float32, dev)
    vp = rand(rng, (npool, page, KH, hd), torch.float32, dev)
    table = torch.arange(npool, dtype=torch.int32, device=dev).view(B, nblk)
    lens = torch.tensor([nblk * page, nblk * page - 5], dtype=torch.int32,
                        device=dev)
    perm = torch.from_numpy(rng.permutation(npool)).to(dev)
    inv = torch.argsort(perm).to(torch.int32)
    a = paged_kernel.paged_attention(q, kp, vp, table, lens)
    b = paged_kernel.paged_attention(q, kp[perm], vp[perm],
                                     inv[table.long()], lens)
    if not torch.equal(a, b):
        raise AssertionError("paged kernel: permuted table changed the bits")
    log("paged  permuted page table: bit-identical")

    # the serving shapes
    Bm, Hm, hdm = BATCH, 32, 64
    q = rand(rng, (Bm, PROMPT, Hm, hdm), torch.bfloat16, dev)
    k = rand(rng, (Bm, PROMPT, Hm, hdm), torch.bfloat16, dev)
    v = rand(rng, (Bm, PROMPT, Hm, hdm), torch.bfloat16, dev)
    err_flash = check_close(
        "flash serving shape", flash_ops.flash_attention(q, k, v),
        attn.reference_attention(q, k, v), TOLS[torch.bfloat16],
        TOLS[torch.bfloat16])
    per_seq = MAX_LEN // lm.PAGE_SIZE
    qd = rand(rng, (Bm, Hm, hdm), torch.bfloat16, dev)
    pool_k = rand(rng, (Bm * per_seq, lm.PAGE_SIZE, Hm, hdm),
                  torch.bfloat16, dev)
    pool_v = rand(rng, (Bm * per_seq, lm.PAGE_SIZE, Hm, hdm),
                  torch.bfloat16, dev)
    table, lens = lm.identity_pages(Bm, MAX_LEN, MAX_LEN - 2, 0, dev)
    err_paged = check_close(
        "paged serving shape",
        paged_ops.paged_attention(qd, pool_k, pool_v, table, lens),
        paged_ops.paged_attention(qd.cpu(), pool_k.cpu(), pool_v.cpu(),
                                  table.cpu(), lens.cpu()).to(dev),
        TOLS[torch.bfloat16], TOLS[torch.bfloat16])
    log(f"flash  serving shape q/k/v {tuple(q.shape)} bf16 causal: max abs "
        f"err {err_flash:.3e}")
    log(f"paged  serving shape q {tuple(qd.shape)} pool "
        f"{tuple(pool_k.shape)} bf16, {table.shape[1]} pages, length "
        f"{int(lens[0])}: max abs err {err_paged:.3e}")
    torch.cuda.synchronize()
    return err_flash, err_paged


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def phase_main_path(dev):
    cfg = get_config(ARCH)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, gen, device=dev)
    serve = ServeLoop(cfg, params, max_len=MAX_LEN, device=dev)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    n_par = sum(t.numel() for t in _leaves(serve.params))
    log(f"main: {ARCH} {cfg.n_layers}L d_model={cfg.d_model} H={cfg.n_heads} "
        f"KH={cfg.n_kv_heads} hd={cfg.hd} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab_size}: {n_par / 1e9:.3f} B params, built in "
        f"{time.perf_counter() - t0:.1f} s")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)

    torch.cuda.synchronize()
    flash_kernel.flash_attention_fwd.launches = 0
    paged_kernel.paged_attention.launches = 0
    toks = serve.generate(prompts, NEW)
    torch.cuda.synchronize()
    launches = {"flash_attention_fwd": flash_kernel.flash_attention_fwd.launches,
                "paged_attention": paged_kernel.paged_attention.launches}
    log(f"main: generate -> tokens {tuple(toks.shape)}; launches {launches}")
    want = {"flash_attention_fwd": cfg.n_layers,
            "paged_attention": cfg.n_layers * (NEW - 1)}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if tuple(toks.shape) != (BATCH, NEW) or \
            not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError("generated tokens out of range")

    with torch.inference_mode():
        tokens = torch.from_numpy(prompts).to(dev)
        logits0, cache = serve.prefill(serve.params, {"tokens": tokens})
        full = lm.init_cache(cfg, MAX_LEN, BATCH, device=dev)
        for n in full:
            full[n][:, :, :PROMPT] = cache[n]
        first = logits0[:, :cfg.vocab_size].argmax(-1).to(torch.int32)[:, None]
        step_logits, _ = lm.decode_step(cfg, serve.params, full, first, PROMPT)
        seq = torch.cat([tokens, first], dim=1)
        fwd_logits, _, _ = lm.forward(cfg, serve.params, {"tokens": seq})
        ref = fwd_logits[:, PROMPT]
        for what, t in (("prefill", logits0), ("decode", step_logits),
                        ("forward", ref)):
            if not bool(torch.isfinite(t.float()).all()):
                raise AssertionError(f"{what} logits are not finite")
        V = cfg.vocab_size
        err = check_close("first decode step vs forward", step_logits[:, :V],
                          ref[:, :V], LOGIT_ATOL, LOGIT_RTOL)
        agree = (step_logits[:, :V].argmax(-1) == ref[:, :V].argmax(-1))
        same_first = bool(torch.equal(first[:, 0], toks[:, 0]))
        same_second = (step_logits[:, :V].argmax(-1).to(torch.int32)
                       == toks[:, 1])
    log(f"main: first decode step vs forward over prompt+token: max abs err "
        f"{err:.3e} (|ref| max {ref.float().abs().max().item():.3f}; atol "
        f"{LOGIT_ATOL} rtol {LOGIT_RTOL}); greedy agreement "
        f"{int(agree.sum())}/{BATCH}; generate's token 0 reproduced: "
        f"{same_first}, token 1: {int(same_second.sum())}/{BATCH}")
    return cfg, serve, prompts, launches


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------

def phase_times(dev, cfg, serve, prompts):
    rng = np.random.default_rng(1)
    dt = torch.bfloat16
    B, S, H, KH, hd = BATCH, PROMPT, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    sets = [tuple(rand(rng, (B, S, n, hd), dt, dev) for n in (H, KH, KH))
            for _ in range(4)]                       # 4 x 33.5 MB > L2
    flash_ms = cuda_ms(lambda i: flash_kernel.flash_attention_fwd(*sets[i]),
                       4, 50)
    flash_plain_ms = cuda_ms(
        lambda i: attn.reference_attention(*sets[i]), 4, 10)
    t_sets = [tuple(t.transpose(1, 2).contiguous() for t in s) for s in sets]
    flash_lib_ms = cuda_ms(
        lambda i: F.scaled_dot_product_attention(*t_sets[i], is_causal=True),
        4, 50)
    esz = 2
    pairs = S * (S + 1) // 2
    flash_bound = bound(2 * B * S * H * hd * esz + 2 * B * S * KH * hd * esz,
                        4 * B * H * hd * pairs, dt)
    del sets, t_sets

    per_seq = MAX_LEN // lm.PAGE_SIZE
    length = MAX_LEN - 1                             # the last decode step
    table, lens = lm.identity_pages(B, MAX_LEN, length - 1, 0, dev)
    q = rand(rng, (B, H, hd), dt, dev)
    pools = [tuple(rand(rng, (B * per_seq, lm.PAGE_SIZE, KH, hd), dt, dev)
                   for _ in range(2)) for _ in range(8)]   # 8 x 17.8 MB
    paged_ms = cuda_ms(lambda i: paged_kernel.paged_attention(
        q, *pools[i], table, lens), 8, 200)
    paged_plain_ms = cuda_ms(lambda i: paged_ops.paged_attention_ref(
        q, *pools[i], table, lens), 8, 20)
    paged_bound = bound(2 * B * length * KH * hd * esz + 2 * B * H * hd * esz
                        + table.numel() * 4 + lens.numel() * 4,
                        4 * B * H * hd * length, dt)
    del pools
    log(f"times at the serving shapes (CUDA events, mean of many launches):")
    log(f"  flash  q/k/v {(B, S, H, hd)} bf16 causal: kernel {flash_ms:.4f} "
        f"ms, plain {flash_plain_ms:.4f} ms, sdpa {flash_lib_ms:.4f} ms, "
        f"bound {flash_bound[0]:.4f} ms ({flash_bound[1]})")
    log(f"  paged  q {(B, H, hd)} over {table.shape[1]} pages x "
        f"{lm.PAGE_SIZE}, length {length}: kernel {paged_ms:.4f} ms, plain "
        f"{paged_plain_ms:.4f} ms, bound {paged_bound[0]:.4f} ms "
        f"({paged_bound[1]})")

    # serving: prefill and decode on the full model
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
        full = lm.init_cache(cfg, MAX_LEN, B, device=dev)
        for n in full:
            full[n][:, :, :PROMPT] = cache[n]
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
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  prefill {B}x{S}: {prefill_ms:.3f} ms (host clock, synchronized, "
        f"mean of {reps})")
    log(f"  decode: {decode_ms:.3f} ms/step by CUDA events ({host_ms:.3f} ms "
        f"host), {B * 1e3 / decode_ms:.1f} tokens/s at batch {B}; peak "
        f"memory {peak_gb:.2f} GB")
    return {"flash": (flash_ms, flash_plain_ms, flash_lib_ms, flash_bound),
            "paged": (paged_ms, paged_plain_ms, None, paged_bound),
            "prefill_ms": prefill_ms, "decode_ms": decode_ms}


# ---------------------------------------------------------------------------
# phase 5: where the time goes (torch.profiler)
# ---------------------------------------------------------------------------

KINDS = (("flash kernel", ("flash_fwd_",)),
         ("paged kernel", ("paged_attn_kernel",)),
         ("gemm", ("gemm", "xmma", "nvjet", "cutlass", "cublas")),
         ("copy/cast", ("copy", "convert", "to_copy")))


def _kind(name):
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def _profile(fn):
    """Host wall ms of ``fn`` and its device kernels (name -> (us, n))."""
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
    return wall_ms, kernels


def _report(what, wall_ms, kernels, steps=1):
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


def phase_profile(dev, cfg, serve, prompts):
    steps = 8
    with torch.inference_mode():
        batch = {"tokens": torch.from_numpy(prompts).to(dev)}
        box = {}

        def prefill():
            box["out"] = serve.prefill(serve.params, batch)
        wall, kern = _profile(prefill)
        log("where the time goes (torch.profiler, per call):")
        _report(f"prefill {tuple(prompts.shape)}", wall, kern)
        logits0, cache = box["out"]
        full = lm.init_cache(cfg, MAX_LEN, BATCH, device=dev)
        for n in full:
            full[n][:, :, :PROMPT] = cache[n]
        nxt = logits0[:, :cfg.vocab_size].argmax(-1).to(torch.int32)[:, None]

        def decode():
            t = nxt
            for pos in range(PROMPT, PROMPT + steps):
                t, _ = serve.step(serve.params, full, t, pos)
        wall, kern = _profile(decode)
        _report(f"decode step (mean of {steps})", wall, kern, steps)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    name, count, smi_line = phase_card_and_build()
    err_flash, err_paged = phase_kernels_vs_plain(dev)
    cfg, serve, prompts, launches = phase_main_path(dev)
    times = phase_times(dev, cfg, serve, prompts)
    phase_profile(dev, cfg, serve, prompts)
    kernels = []
    for key, kname, src, replaces, err in (
            ("flash", "flash_attention_fwd", "src/repro_torch/csrc/flash_fwd.cu",
             "src/repro/kernels/flash_attention/kernel.py:71", err_flash),
            ("paged", "paged_attention", "src/repro_torch/csrc/paged_attn.cu",
             "src/repro/kernels/paged_attn/kernel.py:70", err_paged)):
        ms, plain_ms, lib_ms, (bound_ms, bound_by) = times[key]
        kernels.append({"name": kname, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[kname],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": lib_ms})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels, "prefill_ms": times["prefill_ms"],
                      "decode_ms_per_step": times["decode_ms"]}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
