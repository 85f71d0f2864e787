#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root, on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits nonzero):

1. the card's name, count and power limit; build the seven CUDA kernel
   sources (flash attention forward and backward, paged attention, the
   Mamba2 SSD chunk step and its backward, the MoE dispatch's slot
   positions, AdamW's gradient norm and update) from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, in parallel) and print the compiler's register / shared-memory
   / spill report (the flash forward's MLA instance, q/k 192 and v 128,
   among them), with the flash backward's CTA shapes at each head dim;
2. each kernel against its plain PyTorch version on CUDA tensors: the
   MoE slot kernel bit for bit at the benchmark cells' dispatch calls
   (``moe_slot_shapes``; uniform draws and every slot on one expert), the
   AdamW update kernel bit for bit given the plain version's scale, lr
   and bias corrections (fp32 and bf16, odd sizes, views off the vector
   boundary; then deepseek-v2-lite's 29 training leaves, leaf by leaf)
   and its norm within 1e-6 of the plain global norm, the
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
   and S = 130; in bf16 also at the edges of its tiles, Sk != S both
   ways, windows with GQA 4:1, and strided and misaligned inputs through
   the wrapper; two calls bit-identical at every shape; the tile rule
   compiled into its kernels against its mirror in ``ref.py``), the SSD
   backward kernel against its plain explicit backward and, in bf16,
   against the split arithmetic of its tensor-core instance (bf16 and
   fp32, four nonzero cotangents, fast and slow decay, hp 16/32/64 x ns
   8..128, a chunk that is not a multiple of 16, ragged 64-row tiles;
   two calls bit-identical) and
   the gradient of the full SSD op (an initial state, a padded S) against
   autograd of the plain chunked SSD, and every kernel at the shapes of
   the serving and training runs (qwen2-vl-2b's among them: paged with
   G = 6 query heads a KV head at hd 128, flash forward and backward at
   GQA 6:1, hd 128; mixtral-8x22b's: paged at q (4, 48, 128) over 8 KV
   heads, the flash backward at (2, 4096, 48 heads, 8 KV heads) with its
   window; deepseek-v2-lite-16b's: the flash forward at q/k 192, v 128
   in bf16 and fp32 at S = 512, 513 and 130 with its lse, on MLA's
   layouts, two calls bit-identical); then mixtral's sliding-window ring
   cache: its smoke model (hd 32, window 64) decoding from a prompt of
   128 to position 160 through the paged kernel, against the forward,
   and again at window 40 (a cache of 2.5 pages, wrapping at pos % 40)
   from 80 to 120; the paged kernel's (out, lse) against the plain
   version's (bf16 and fp32, hd 64, qwen2-vl-2b's G 6, granite-34b's G
   48 in row tiles, a zero-length row with lse <= -1e30; out bit-identical
   to the launch without lse);
3. the main paths, each through ``ServeLoop.generate`` at full width with
   random weights from a seeded CUDA generator and bf16 compute, 4 prompts
   of 512 tokens and 32 new tokens: ``stablelm-1.6b`` (dense: flash at
   prefill, paged at decode), ``zamba2-2.7b`` (hybrid: the SSD kernel in
   each of its 54 Mamba2 layers at prefill and at every decode step, flash
   and paged in the 9 applications of its tied attention block),
   ``mamba2-130m`` (ssm: the SSD kernel in its 24 layers), ``qwen2-vl-2b``
   (vlm: M-RoPE, GQA 6:1 at hd 128; also a prefill from patch embeddings
   with a patch-grid pos3, held against the forward) and
   ``musicgen-large`` (audio: 4 codebook streams, (4, 512, 4) prompts,
   flash and paged in its 48 layers), ``mixtral-8x22b`` (moe: 12 of its
   56 layers, bf16 weights, 16 sub-experts, sliding-window GQA 6:1 at hd
   128: flash and paged in each layer) and ``deepseek-v2-lite-16b`` (moe
   with MLA, full depth, bf16 weights: flash at q/k 192, v 128 in its 27
   layers, the absorbed decode in plain torch). The launch counters, set
   to 0 just before each run and read just after, must equal what that
   path launches; each model's first decode step is held against a full
   forward over prompt + token (the moe family's on a drop-free copy in
   fp32 compute, the forward taking decode's routes for the new token
   where its own differ by a near-tie). For stablelm-1.6b and
   qwen2-vl-2b, the KV pager: the serving run's whole cache (every layer
   and sequence, 34 pages of 16 tokens each) is put into a ``KVPager``
   whose frames hold one layer's pages, spilling to its host and cold
   tiers; layer by layer the pages are refaulted and pinned, and the
   paged kernel over ``device_pools()`` through the table from
   ``slot_of`` must give the bits of the kernel over the dense cache
   (the pager's counters are printed as simulated). Then the training
   paths: ``TrainLoop`` at full width and full depth, each layer
   rematerialised, for 6 AdamW steps of 2 x 4096 tokens from a
   ``RingLoader`` over a synthetic corpus (no checkpoint is due in the
   run: a full-width one is 26-38 GB), on ``stablelm-1.6b`` (dense: 48 forward and 24 backward
   flash launches a step), ``zamba2-2.7b`` (hybrid, 2 microbatches: 216
   SSD chunk and 108 SSD backward launches, 36 flash forward and 18 flash
   backward a step), ``mamba2-130m`` (ssm: 48 and 24 SSD launches),
   ``qwen2-vl-2b`` (on stand-in patch embeddings with a patch-grid pos3
   and the ring's labels: 56 and 28 flash launches) and
   ``musicgen-large`` (on (2, 4096, 4) tokens reshaped from ring reads:
   96 and 48) and ``mixtral-8x22b`` (1 of its 56 layers, one microbatch:
   2 and 1), and each step's AdamW (a sum of squares and an update a
   table of 64 fp32 leaves, and one finish); the counters must equal
   what ``train_launches`` derives from each config. For stablelm,
   qwen2-vl and musicgen (2 layers), mixtral (1 layer; the plain step routes as the kernel step did) and
   zamba2 (one group: 6 Mamba2 layers and the tied block), one step's
   loss and gradients at full width are held against the same step with
   attention and the SSD through autograd of their plain versions, and
   (stablelm, zamba2) a
   smoke-size run that crashes at step 8 and restarts from the ring
   checkpoint of step 5 must end bitwise equal to the uninterrupted run,
   under ``torch.use_deterministic_algorithms(True)``. Then the mesh
   path: a 1 x 1 ("data", "model") mesh (``make_local_mesh``) over a
   one-rank NCCL group; ``stablelm-1.6b`` trains 3 steps on it
   (``TrainLoop(mesh=, rules=)``, parameters placed by ``param_specs``),
   saves a ring checkpoint on the mesh and ``restore(shardings=None)``
   must give its leaves back bit for bit; ``deepseek-v2-lite-16b`` (its
   dense and one MoE layer) trains 3 steps with ``moe_impl="shard_map"``
   (dispatch and combine through ``all_to_all_single``); ``zamba2-2.7b``
   prefills 4 x 512 (the SSD kernel on the mesh's blocks). Each against
   its ``mesh=None`` twin from the same seed (losses and watched leaves
   within 1e-5 relative; deepseek's routes replayed; zamba2's logits and
   cache within the hybrid tolerance), whether bit-identical printed,
   with both runs' step times and launches; then decode on that mesh
   (``lm.decode_step(mesh=, rules=)``: the cache placed by
   ``cache_specs``, the paged kernel with lse on the rank's shard and the
   fp32 merge of shards; MLA on DTensors) for ``stablelm-1.6b``,
   ``zamba2-2.7b`` and ``deepseek-v2-lite-16b`` (2 layers, shard_map), 8
   steps after a prefill, bit for bit its mesh=None twin in logits and
   tokens, with equal paged and SSD launches;
4. device times (CUDA events over launches queued behind a held stream,
   after warm-up) of each kernel (the MoE slot kernel alone at the cells'
   dispatch calls; AdamW's two passes at deepseek-v2-lite's 29 training
   leaves, beside ``torch._fused_adamw_``), its plain version, its bound
   and, where one PyTorch call computes the same function, that call as a yardstick
   the port never calls, at the serving shapes (paged at the first and
   last decode lengths, 33 and 34 pages, with its cluster shape, also at
   qwen2-vl's and mixtral's G = 6; flash with its CTA shape, also at GQA
   6:1, hd 128, and at deepseek-v2-lite's q/k 192, v 128; paged and
   flash at granite-34b's, yi-34b's and deepseek-67b's decode and
   prefill; the SSD kernel with its plan, also at a decode
   step's chunk of one token, bound at the TF32 tensor-core rate or the
   bytes; the paged kernel also writing lse, at hd 64, G 6 and G 48);
   each model's prefill and decode times (stablelm's and zamba2's decode
   walls also with the kernel ops' entry points calling the wrappers
   directly, as before the ops were torch custom ops, in turns); the
   train step's time
   and tokens/s of each training run, the flash backward at the training
   shapes (stablelm's, qwen2-vl's, mixtral's, deepseek-v2-lite's at q/k
   192, v 128) beside its bound and the
   backward of
   ``scaled_dot_product_attention``, the flash forward at the training
   shape, and the SSD chunk kernel and its backward at zamba2's and
   mamba2's training calls (the backward beside its plain version, its
   bound and the bf16 products its split issues, with each of its
   kernels' CTAs, registers and spills; no one PyTorch call computes
   it);
5. where the time goes: ``torch.profiler`` over one prefill and eight
   decode steps of each model (of the three large dense configs,
   granite-34b only), and over one train step of each training
   run (forward and backward; the optimizer by CUDA events), device
   busy share,
   kernel time by kind, the SSD backward's kernels one by one and the MoE
   layers' time by stage (router, dispatch, experts, combine, shared);
6. the dry run (``launch/dryrun.py``) in subprocesses started together,
   on fake CUDA tensors over a fake process group (no card memory):
   stablelm-1.6b's train_4k and decode_32k cells on the 16 x 16 mesh
   (FLOPs, bytes, collectives by kind, peak, bound, trace time), and
   phase 4's stablelm training step on one device, whose traced FLOPs
   over the measured step are printed as TFLOP/s and as a share of 989
   TFLOP/s beside the card's name and power limit;
7. the paper's storage and network engines (``repro_torch.storage``,
   ``wal``, ``lsm``, ``replication``, ``shuffle``), host code on the
   simulated clock that touches no tensor: the Fig. 5 ladder at 200,000
   tuples and 300 transactions (``+SQPoll``'s tx/s above ``posix``'s), a
   ``+GroupCommit`` crash recovered by ``recover`` and an LSM crash during
   compaction by ``recover_lsm`` (every acknowledged commit read back), a
   ``+SyncRepl`` failover (no acknowledged commit lost; after a quiesced
   run the standby's log and promoted map are the primary's), and
   ``ShuffleEngine``'s egress within 20% of ``ShuffleSim``'s at 512 B and
   4 KiB tuples. Its numbers are marked simulated (virtual clock), beside
   the phase's host wall seconds.

The last lines are a JSON object with one entry per kernel, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
Without a CUDA device the script prints no result and exits 2.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import pathlib
import shutil
import struct
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
from repro_torch.kernels.adamw import kernel as adamw_kernel  # noqa: E402
from repro_torch.kernels.adamw.ref import (adamw_norm_ref,    # noqa: E402
                                           adamw_sumsq_ref,
                                           adamw_update_ref, grad_norm_ref)
from repro_torch.kernels.flash_attention import kernel as flash_kernel  # noqa
from repro_torch.kernels.flash_attention import ops as flash_ops        # noqa
from repro_torch.kernels.flash_attention.ref import (        # noqa: E402
    flash_attention_bwd_ref, flash_attention_fwd_ref, tile_kinds)
from repro_torch.kernels.moe_slots import kernel as slots_kernel        # noqa
from repro_torch.kernels.moe_slots.ref import moe_slots_ref              # noqa
from repro_torch.kernels.paged_attn import kernel as paged_kernel       # noqa
from repro_torch.kernels.paged_attn import ops as paged_ops             # noqa
from repro_torch.kernels.paged_attn.ref import paged_attention_split_ref  # noqa
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel           # noqa
from repro_torch.kernels.ssd_scan import ops as ssd_ops                 # noqa
from repro_torch.kernels.ssd_scan.ref import (ssd_chunk_bwd_ref,  # noqa
                                              ssd_chunk_bwd_split_ref,
                                              ssd_chunk_ref,
                                              ssd_chunk_split_ref, ssd_ref)
from repro_torch.launch.mesh import HBM_BW                     # noqa: E402
from repro_torch.launch.steps import (loss_and_grads,        # noqa: E402
                                      make_prefill_step, make_train_step)
from repro_torch.lsm import recover_lsm                         # noqa: E402
from repro_torch.models import attention as attn               # noqa: E402
from repro_torch.models import lm                              # noqa: E402
from repro_torch.models import moe as moe_mod                  # noqa: E402
from repro_torch.models import partitioning as part           # noqa: E402
from repro_torch.optim import (adamw_init, adamw_update,       # noqa: E402
                               cosine_schedule)
from repro_torch.replication import ReplicatedCluster         # noqa: E402
from repro_torch.roofline import work                          # noqa: E402
from repro_torch.serve import KVPager, PagerConfig, ServeLoop  # noqa: E402
from repro_torch.shuffle import (ShuffleConfig, ShuffleEngine,  # noqa: E402
                                 ShuffleSim)
from repro_torch.storage.engine import (EngineConfig,       # noqa: E402
                                        StorageEngine, make_engine)
from repro_torch.storage.workloads import ycsb_update_txn       # noqa: E402
from repro_torch.train import TrainLoop, TrainLoopConfig       # noqa: E402
from repro_torch.tree import tree_leaves, tree_map             # noqa: E402
from repro_torch.wal import recover                            # noqa: E402

# NVIDIA H100 SXM data sheet (dense, no sparsity), at the 700 W limit,
# and each kernel's work: roofline/work.py, which the dry run reads too
PEAK_BYTES_PER_S = HBM_BW
PEAK_FLOPS = {torch.bfloat16: work.PEAK_FLOPS["bfloat16"],
              torch.float32: work.PEAK_FLOPS["float32"]}
# the SSD kernel's products run on the tensor cores from split operands:
# its bound takes the function's operations at the TF32 rate
SSD_RATE = ("TF32 tensor cores", work.TF32_FLOPS)

TOLS = {torch.float32: 2e-5, torch.bfloat16: 2e-2}     # tests/test_kernels.py
PAGED_TOL_F32 = 3e-5
SSD_ATOL, SSD_RTOL = 2e-5, 2e-4                        # tests/test_kernels.py
FLASH_SHAPES = [(2, 256, 4, 2, 64, 0), (1, 512, 4, 1, 128, 0),
                (2, 128, 8, 8, 32, 64), (1, 256, 2, 2, 64, 128)]
PAGED_SHAPES = [(2, 4, 2, 64, 32, 4), (3, 8, 2, 64, 16, 8),
                (1, 4, 4, 128, 64, 2),
                (2, 16, 4, 128, 64, 5),                # GQA, hd 128, pages of 64
                (4, 48, 1, 128, 16, 34),               # granite-34b: row tiles
                (4, 56, 8, 128, 16, 34),               # yi-34b: G 7
                (4, 64, 8, 128, 16, 34)]               # deepseek-67b: G 8
SSD_SHAPES = [(2, 128, 4, 32, 16, 32), (1, 256, 8, 16, 32, 64),
              (2, 64, 2, 64, 64, 64)]                  # B, S, nh, hp, ns, cl
KERNELS = {"flash_attention_fwd": flash_kernel.flash_attention_fwd,
           "flash_attention_bwd": flash_kernel.flash_attention_bwd,
           "paged_attention": paged_kernel.paged_attention,
           "ssd_chunk_call": ssd_kernel.ssd_chunk_call,
           "ssd_chunk_bwd": ssd_kernel.ssd_chunk_bwd,
           "moe_slots": slots_kernel.moe_slots,
           "adamw_sumsq": adamw_kernel.adamw_sumsq,
           "adamw_norm": adamw_kernel.adamw_norm,
           "adamw_update_": adamw_kernel.adamw_update_}
# the flash backward against the plain block-recompute backward: the same
# fp32 arithmetic from the same inputs, so TOLS (bf16: one rounding of the
# outputs); the lse output is fp32 in both (measured <= 9.5e-7)
FLASH_BWD_SHAPES = [(2, 256, 4, 2, 64, 0), (1, 513, 4, 1, 128, 0),
                    (2, 128, 8, 8, 32, 64), (1, 200, 4, 2, 80, 48),
                    (2, 130, 4, 4, 64, 0), (1, 513, 8, 2, 64, 100)]
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

# the SSD backward against its plain version (both fp32 arithmetic from the
# same inputs, sums of up to 256 terms a chunk in other orders): each
# gradient within SSD_BWD_TOL of its scale (``grad_scales``: its largest
# element; for dA_log, a sum over every token of terms that cancel, the
# sum of their sizes; PERF.md has the measured errors); a bf16 dx/dB/dC
# may also sit one bf16 ulp (2^-7 relative) from the plain one, the two
# fp32 sums rounding to neighbours
SSD_BWD_TOL, BF16_ULP = 1e-4, 2.0 ** -7
# B, S, nh, hp, ns, cl: the smoke configs' shape (hp 32, ns 16, cl 32), a
# chunk that is not a multiple of 16 (and of the 64-row tiles), one chunk
# of 200 in two ragged tiles, and the training calls of zamba2-2.7b (one
# microbatch of 4096) and mamba2-130m (2 x 4096)
SSD_BWD_SHAPES = [(2, 128, 4, 32, 16, 32), (1, 200, 4, 32, 16, 100),
                  (2, 96, 3, 16, 8, 48), (1, 200, 2, 64, 64, 200),
                  (1, 4096, 80, 64, 64, 256), (2, 4096, 24, 64, 128, 256)]
# slow decay: with tests/test_kernels.py's dt (softplus of N(0, 1), about
# 0.8) and A about -1, dt·A is about -0.8 a token, so exp(tot) (about
# 1e-12 at cl 32), w_j away from the chunk's end and L between tiles two
# apart are too small for an error in them to show. dt scaled by SLOW_DT
# makes dt·A about -0.008 a token: exp(tot) about 0.1 at cl 256, and every
# term of the backward the size of the others. The smoke shape, cl 200
# (ragged tiles) and 256 (four 64-row tiles), then the training calls.
SLOW_DT = 0.01
SSD_BWD_SLOW_SHAPES = [(2, 128, 4, 32, 16, 32), (1, 200, 2, 64, 64, 200),
                       (2, 512, 3, 64, 128, 256)]

# the serving runs: 4 prompts x 512 tokens (musicgen: 4 codebook streams a
# position), 32 new tokens, one per model
ARCHS = ("stablelm-1.6b", "zamba2-2.7b", "mamba2-130m", "qwen2-vl-2b",
         "musicgen-large", "mixtral-8x22b", "deepseek-v2-lite-16b",
         "granite-34b", "yi-34b", "deepseek-67b")
BATCH, PROMPT, NEW, MAX_LEN = 4, 512, 32, 544
# depth cut for the card: mixtral-8x22b is 5.008 GB of bf16 weights a layer
# (16 sub-experts of 3 x 6144 x 8192, attention 88.1 M), 56 layers 281 GB;
# 12 layers and the embedding and head are 60.9 GB of the 80. The moe
# family is initialised in bf16 (an fp32 init and a bf16 copy would not
# fit: deepseek-v2-lite-16b is 63 GB in fp32), served at full width.
# The three large dense configs likewise, in bf16 and cut in depth:
# granite-34b 16 of 88 layers (13.34 GB; MQA, 48 query heads over one KV
# head at hd 128, the paged kernel's 6 row tiles), yi-34b 12 of 60 (15.22
# GB; GQA 7:1) and deepseek-67b 12 of 95 (19.97 GB; GQA 8:1).
SERVE_LAYERS = {"mixtral-8x22b": 12, "granite-34b": 16, "yi-34b": 12,
                "deepseek-67b": 12}
# their kernels-line labels, query rows a KV head (G) and KV heads
DENSE_LARGE = (("granite_34b", 48, 1), ("yi_34b", 7, 8),
               ("deepseek_67b", 8, 8))
# phase 5 profiles each served model but these two, whose decode runs the
# paged kernel's one-tile path as qwen2-vl's and mixtral's do (granite's,
# the row-tile path, is profiled)
PROFILE_SKIP = ("yi-34b", "deepseek-67b")
# any cache length (phase 3): stablelm generates this many tokens from the
# same prompts with a cache of ANY_LEN positions (not whole pages) and of
# MAX_LEN, and the tokens must be equal
ANY_LEN, ANY_LEN_NEW = 530, 16
# and on the card past such a length: mixtral's smoke ring cache (phase 2)
# also with this window, 2.5 pages, so decode wraps at pos % 40
RING_ANY_LEN = 40
# first decode step vs a full forward, both bf16 compute through every
# layer (different GEMM shapes, flash vs paged attention): logits agree to
# within bf16 rounding carried through the layers, (atol, rtol) per family.
# mamba2-130m's decode step repeats the forward's arithmetic for that token
# (a one-token chunk runs the same kernel sums) and has matched it bit for
# bit; zamba2-2.7b's 54 Mamba2 layers carry the rounding of 9 attention
# blocks further than stablelm's 24 layers: 0.445 at |logit| <= 4.2 on the
# H100 with the wgmma flash kernel (0.256 with the mma.sync one) against
# stablelm's 0.078 at <= 5.0
#
# moe: the first decode step of a drop-free copy (drops depend on the
# dispatch group by design) in fp32 compute. Drop-free is capacity factor
# ceil(E / k): an expert takes a token at most once, so C >= S slots
# cannot overflow (tests/test_models.py's 8.0 is not enough at full width
# with random weights: on the card one of deepseek-v2-lite's 64 experts
# took 511 of 513 tokens, C 384). fp32, since in
# bf16 decode and the forward round the residual stream at other places
# and a router whose k-th and (k+1)-th probabilities are a rounding apart
# sends the token elsewhere (on the card, smoke mixtral: 3.25 on a row's
# logits); in fp32 only the bf16 cache rounds, and where a route still
# differs the forward takes decode's (``MoERoutes``), if the two were
# within FLIP_GAPS' share of each other (else the check fails). What is
# left is the bf16 cache's rounding carried through the layers: on the
# H100, 0.0163 at |logit| <= 4.3 (mixtral, 12 layers) and 0.0142 at <= 5.0
# (deepseek-v2-lite, 27 layers).
LOGIT_TOLS = {"dense": (0.15, 0.05), "hybrid": (0.4, 0.05),
              "ssm": (0.15, 0.05), "vlm": (0.15, 0.05), "audio": (0.2, 0.05),
              "moe": (0.05, 0.05)}
# the ring cache's decode vs the forward (bf16, smoke mixtral, every token
# to all experts): on the H100, 0.0508
RING_TOL = (0.1, 0.03)
# a route flip between two paths is a near-tie when the router's k-th and
# (k+1)-th probabilities are this close (relative): in fp32 compute only
# the bf16 cache parts the paths (gaps seen <= 4.3e-4); in bf16 the
# residual stream is rounded too, so one bf16 ulp (2^-7; seen 1.08e-3)
FLIP_GAPS = {"float32": 1e-3, "bfloat16": 2.0 ** -7}
# rows of the moe check: mixtral's fp32 forward casts a layer's 2.4 G
# expert weights to fp32 (9.7 GB) beside its 60.9 GB of weights, so it
# checks 2 of the 4 prompts
MOE_CHECK_ROWS = {"mixtral-8x22b": 2, "deepseek-v2-lite-16b": 4}
# families whose every layer is a transformer block: flash at prefill, and
# at decode paged (MLA: its absorbed decode in plain torch), in each layer
ATTN_ONLY = ("dense", "vlm", "audio", "moe")
# qwen2-vl-2b's images, one frame of patch tokens then text, M-RoPE ids as
# in Qwen2-VL (the patch grid's (t, h, w), then text from the grid's largest
# id + 1): 16 x 16 patches (448 x 448 pixels after its 2 x 2 merge) in a
# 512-token prompt, 32 x 32 (896 x 896) in a 4096-token training row
VLM_GRID_SERVE, VLM_GRID_TRAIN = (1, 16, 16), (1, 32, 32)

# the training runs: one model of each family at full width and depth,
# train_4k's sequence (configs/base.py), a global batch cut from 256 to 2;
# mixtral-8x22b at 1 of 56 layers (2.906 G parameters: fp32 params, grads,
# m and v at 16 B each are 46.5 GB; 2 layers would be 86.6 GB) and in one
# microbatch (its config's 8 split the global batch of 256);
# deepseek-v2-lite-16b at 5 of 27 layers (its 1 dense layer and 4 MoE
# layers, MLA in each: 2.840 G parameters, 45.4 GB of training state) in
# one microbatch
TRAIN_ARCHS = ("stablelm-1.6b", "zamba2-2.7b", "mamba2-130m", "qwen2-vl-2b",
               "musicgen-large", "mixtral-8x22b", "deepseek-v2-lite-16b")
TRAIN_LAYERS = {"mixtral-8x22b": 1, "deepseek-v2-lite-16b": 5}
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 4096, 6
# one step at full width and one group of layers (stablelm: 2 layers;
# zamba2: attn_every Mamba2 layers and the tied block), the kernels vs
# autograd of the plain attention and the plain chunked SSD, both bf16
# compute: the loss to 2e-3 relative and each gradient leaf to 2e-2
# relative L2 (a few bf16 roundings, 2^-8 each)
GRAD_ARCHS = ("stablelm-1.6b", "zamba2-2.7b", "qwen2-vl-2b",
              "musicgen-large", "mixtral-8x22b", "deepseek-v2-lite-16b")
# deepseek-v2-lite: its dense layer and one MoE layer, both MLA
GRAD_LAYERS = {"mixtral-8x22b": 1, "deepseek-v2-lite-16b": 2}
RESTART_ARCHS = ("stablelm-1.6b", "zamba2-2.7b")
# the pager phase: real bf16 KV of a serving run's cache (every layer, every
# sequence, 34 pages of 16 tokens) in a KVPager whose frames hold one
# layer's pages and PAGER_SLACK more, with a host tier smaller than the
# rest, so that pages spill to both tiers and each layer refaults
PAGER_ARCHS = ("stablelm-1.6b", "qwen2-vl-2b")
PAGER_SLACK, PAGER_HOST_SHARE = 16, 0.25
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
    return work.bound_ms(bytes_moved, flops, PEAK_FLOPS[dtype])


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
    for hd in flash_kernel.HEAD_DIMS:
        log(f"  flash bwd bf16 CTAs at hd {hd}: {flash_kernel.plan_bwd(hd)}")
    log(f"  flash fwd bf16 CTA at MLA's q/k 192, v 128: "
        f"{flash_kernel.plan(*flash_kernel.MLA_DIMS)}")
    log(f"  flash bwd bf16 CTAs at MLA's q/k 192, v 128 (dK/dV in two "
        f"passes): {flash_kernel.plan_bwd(*flash_kernel.MLA_DIMS)}")
    for what, G in (("granite-34b", 48), ("yi-34b", 7), ("deepseek-67b", 8),
                    ("qwen2-vl-2b / mixtral-8x22b", 6)):
        log(f"  paged bf16 plan at {what}'s G {G}, hd 128, 34 pages: "
            f"{paged_kernel.plan(34, lm.PAGE_SIZE, G, 128, torch.bfloat16)}")
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


def ssd_inputs(rng, dev, B, S, nh, hp, ns, dtype, dt_scale=1.0):
    """tests/test_kernels.py's SSD distributions, dt times ``dt_scale``;
    x/B/C in ``dtype``."""
    x = rand(rng, (B, S, nh, hp), dtype, dev, 0.5)
    dt = F.softplus(rand(rng, (B, S, nh), torch.float32, dev)) * dt_scale
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


def grad_scales(grads, dt):
    """What each SSD gradient's tolerance is relative to: its largest
    element, but for dA_log (third) Σ |ddt| dt, the sizes of its terms."""
    out = [float(g.float().abs().max()) for g in grads]
    out[2] = float((grads[1].float().abs() * dt).sum())
    return out


def exp_tot_mean(dt, A_log, cl):
    """The mean over chunks and heads of exp(tot), the decay across a
    whole chunk: how much the terms that carry memory across it weigh."""
    B, S, nh = dt.shape
    tot = dt.reshape(B, S // cl, cl, nh).sum(2) * -torch.exp(A_log)
    return float(tot.exp().mean())


def check_ssd_bwd(rng, dev, B, S, nh, hp, ns, cl, dtype, dt_scale=1.0):
    """The backward kernel against ssd_chunk_bwd_ref on the same inputs and
    four nonzero cotangents and, in bf16, against the split arithmetic of
    its tensor-core instance (ssd_chunk_bwd_split_ref), at the same
    tolerance; a second call bit for bit against the first. Returns the
    largest absolute error against the plain version."""
    args = ssd_inputs(rng, dev, B, S, nh, hp, ns, dtype, dt_scale)
    nc = S // cl
    cots = [rand(rng, shape, torch.float32, dev) for shape in (
        (B, nc, cl, nh, hp), (B, nc, nh, hp, ns), (B, nc, cl, nh),
        (B, nc, nh))]
    got = ssd_kernel.ssd_chunk_bwd(*args, *cots, chunk=cl)
    ref = ssd_chunk_bwd_ref(*args, *cots, chunk=cl)
    refs = {"plain": ref}
    if dtype == torch.bfloat16:
        refs["split"] = ssd_chunk_bwd_split_ref(*args, *cots, chunk=cl)
    what = f"ssd bwd B={B} S={S} nh={nh} hp={hp} ns={ns} cl={cl} " \
        f"{str(dtype)[6:]} dt x{dt_scale} (mean exp(tot) " \
        f"{exp_tot_mean(args[1], args[2], cl):.2e})"
    rel, worst = {}, 0.0
    for kind, other in refs.items():
        for name, a, b, top in zip(("dx", "ddt", "dA_log", "dB", "dC"), got,
                                   other, grad_scales(ref, args[1])):
            if a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError(f"{what} {name}: {a.dtype} "
                                     f"{tuple(a.shape)} vs {b.dtype} "
                                     f"{tuple(b.shape)}")
            rtol = BF16_ULP if a.dtype == torch.bfloat16 else 0.0
            err = check_close(f"{what} {name} vs {kind}", a, b,
                              SSD_BWD_TOL * top, rtol)
            rel[(kind, name)] = err / top
            if kind == "plain":
                worst = max(worst, err)
    again = ssd_kernel.ssd_chunk_bwd(*args, *cots, chunk=cl)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{what}: two calls gave different bits")
    log(f"{what}: max abs err / scale: "
        + "; ".join(f"vs {kind} " + " ".join(
            f"{n} {v:.2e}" for (k, n), v in rel.items() if k == kind)
            for kind in refs)
        + f" (tol {SSD_BWD_TOL}{' + one bf16 ulp' if rtol else ''}); a "
        f"second call bit-identical")
    del refs, ref, got, again
    return worst


def check_ssd_grad(rng, dev, B, S, nh, hp, ns, cl, dtype, dt_scale=1.0):
    """The gradient of the full ops.ssd (SSDChunk: the chunk kernel and
    the backward kernel, plus autograd of the inter-chunk recurrence), from
    an initial state, against autograd of the plain chunked SSD
    (ssd_chunked) on the card, for random weights on y and the final
    state."""
    x, dt, A_log, Bm, Cm = ssd_inputs(rng, dev, B, S, nh, hp, ns, dtype,
                                      dt_scale)
    D = rand(rng, (nh,), torch.float32, dev)
    st0 = rand(rng, (B, nh, hp, ns), torch.float32, dev, 0.2)
    wy = rand(rng, (B, S, nh, hp), torch.float32, dev)
    ws = rand(rng, (B, nh, hp, ns), torch.float32, dev)
    grads = []
    before = ssd_kernel.ssd_chunk_bwd.launches
    for fn in (lambda *a: ssd_ops.ssd(*a[:6], chunk=cl, state=a[6]),
               lambda *a: ssd_ref(*a[:6], cl, state=a[6])):
        leaves = [t.detach().clone().requires_grad_()
                  for t in (x, dt, A_log, Bm, Cm, D, st0)]
        y, st = fn(*leaves)
        ((y.float() * wy).sum() + (st * ws).sum()).backward()
        grads.append([t.grad for t in leaves])
    if ssd_kernel.ssd_chunk_bwd.launches != before + 1:
        raise AssertionError("ops.ssd's gradient did not launch the SSD "
                             "backward kernel once")
    what = f"ssd    grad B={B} S={S} nh={nh} hp={hp} ns={ns} cl={cl} " \
        f"{str(dtype)[6:]} dt x{dt_scale} +state"
    rel = {}
    for name, a, b, top in zip(("x", "dt", "A_log", "B", "C", "D", "state"),
                               *grads, grad_scales(grads[1], dt)):
        # a bf16 x, B or C gets two gradients (the chunk pieces' and the
        # recurrence's or D's), each rounded to bf16, and their bf16 sum,
        # where the plain op rounds once: roundings of terms up to the
        # largest gradient's size, one ulp each
        bf = a.dtype == torch.bfloat16
        rel[name] = check_close(f"{what} d{name}", a, b,
                                (BF16_ULP if bf else SSD_BWD_TOL) * top,
                                BF16_ULP if bf else 0.0) / top
    log(f"{what} vs autograd of the plain chunked SSD: max abs err / scale: "
        + " ".join(f"d{n} {v:.2e}" for n, v in rel.items())
        + f" (tol {SSD_BWD_TOL}; bf16 leaves {BF16_ULP} + {BF16_ULP} "
        f"relative)")


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


def check_flash_mla(rng, dev, B, S, dt, H=16):
    """The forward at MLA's head dims (q/k 192, v 128; causal, scale
    1/sqrt(192)): output and lse against the plain version, a second call
    bit-identical. Returns the output's max abs error."""
    hd, hdv = flash_kernel.MLA_DIMS
    q, k = (rand(rng, (B, S, H, hd), dt, dev) for _ in range(2))
    v = rand(rng, (B, S, H, hdv), dt, dev)
    scale = hd ** -0.5
    o, lse = flash_kernel.flash_attention_fwd(q, k, v, scale=scale,
                                              with_lse=True)
    ref, lse_ref = flash_attention_fwd_ref(q, k, v, scale=scale, q_chunk=64)
    what = f"flash  MLA B={B} S={S} H={H} q/k {hd} v {hdv} {str(dt)[6:]}"
    e = check_close(what, o, ref, TOLS[dt], TOLS[dt])
    e_lse = check_close(what + " lse", lse, lse_ref, LSE_TOL, LSE_TOL)
    if not torch.equal(o, flash_kernel.flash_attention_fwd(q, k, v,
                                                           scale=scale)):
        raise AssertionError(f"{what}: two calls gave different bits")
    log(f"{what}: max abs err {e:.3e} (tol {TOLS[dt]}), lse {e_lse:.3e} "
        f"(tol {LSE_TOL}); a second call bit-identical")
    return e


def check_flash_mla_layouts(rng, dev, B=BATCH, S=PROMPT, H=16):
    """q/k/v at deepseek-v2-lite's prefill shape laid out as ``mla_prefill``
    makes them (k a cat of the per-head nope part and the broadcast rope
    part, v a reshape of the latent's up-projection) and as views into
    wider rows: bit for bit the kernel on contiguous copies, and within
    TOLS of the plain version. Returns the max abs error."""
    dt = torch.bfloat16
    kn = rand(rng, (B, S, H, 128), dt, dev)
    kr = rand(rng, (B, S, 1, 64), dt, dev)
    k = torch.cat([kn, kr.expand(B, S, H, 64)], -1)
    lat = rand(rng, (B, S, 512), dt, dev)
    v = (lat @ rand(rng, (512, H * 128), dt, dev, 512 ** -0.5)) \
        .reshape(B, S, H, 128)
    q = rand(rng, (B, S, H, 192 + 8), dt, dev)[..., :192]
    wide_v = torch.zeros((B, S, H, 136), dtype=dt, device=dev)
    wide_v[..., :128] = v
    want = flash_kernel.flash_attention_fwd(q.contiguous(), k.contiguous(),
                                            v.contiguous())
    for what, args in (("views", (q, k, v)), ("v rows of 136",
                                              (q, k, wide_v[..., :128]))):
        if not torch.equal(flash_kernel.flash_attention_fwd(*args), want):
            raise AssertionError(f"flash MLA layouts ({what}): not the "
                                 f"contiguous call's bits")
    e = check_close("flash MLA layouts", want,
                    flash_attention_fwd_ref(q, k, v)[0], TOLS[dt], TOLS[dt])
    log(f"flash  MLA layouts q/k {(B, S, H, 192)} v 128 (k a cat with the "
        f"broadcast rope part, v a reshape, q rows of 200, v rows of 136): "
        f"bit-identical to contiguous copies; vs plain max abs err {e:.3e}")
    return e


def check_flash_bwd(rng, dev, B, S, H, KH, hd, dt, win=0, q_chunk=64,
                    Sk=None, hdv=None):
    """The forward's output and lse against the plain forward's, then the
    backward kernel against the plain block-recompute backward on the
    same (q, k, v, o, lse, do), and a second call bit for bit against the
    first; v's head dim is ``hdv`` (default ``hd``; MLA's (192, 128)).
    Returns the forward's and the backward's max abs errors."""
    Sk = Sk or S
    hdv = hdv or hd
    q = rand(rng, (B, S, H, hd), dt, dev)
    do = rand(rng, (B, S, H, hdv), dt, dev)
    k = rand(rng, (B, Sk, KH, hd), dt, dev)
    v = rand(rng, (B, Sk, KH, hdv), dt, dev)
    o, lse = flash_kernel.flash_attention_fwd(q, k, v, window=win,
                                              with_lse=True)
    if not torch.equal(o, flash_kernel.flash_attention_fwd(q, k, v,
                                                           window=win)):
        raise AssertionError("flash forward: writing lse changed the output")
    o_ref, lse_ref = flash_attention_fwd_ref(q, k, v, window=win,
                                             q_chunk=q_chunk)
    dims = f"hd={hd}" if hdv == hd else f"q/k {hd} v {hdv}"
    what = f"flash bwd B={B} S={S} Sk={Sk} H={H} KH={KH} {dims} " \
        f"win={win} {str(dt)[6:]}"
    e_o = check_close(what + " forward", o, o_ref, TOLS[dt], TOLS[dt])
    e_lse = check_close(what + " lse", lse, lse_ref, LSE_TOL, LSE_TOL)
    del o_ref
    got = flash_kernel.flash_attention_bwd(q, k, v, o, lse, do, window=win)
    ref = flash_attention_bwd_ref(q, k, v, o, lse, do, window=win,
                                  q_chunk=q_chunk)
    errs = [check_close(f"{what} d{n}", a, b, TOLS[dt], TOLS[dt])
            for n, a, b in zip("qkv", got, ref)]
    again = flash_kernel.flash_attention_bwd(q, k, v, o, lse, do, window=win)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{what}: two calls gave different bits")
    log(f"{what}: max abs err forward {e_o:.3e}, lse {e_lse:.3e} (atol = "
        f"rtol = {LSE_TOL}); dq {errs[0]:.3e} dk {errs[1]:.3e} dv "
        f"{errs[2]:.3e} (atol = rtol = {TOLS[dt]}); a second call "
        f"bit-identical")
    return e_o, max(errs)


def check_flash_bwd_strided(rng, dev):
    """The bf16 backward through the wrapper on views into wider rows
    (16-byte aligned: TMA reads them by their strides; rows of hd + 4:
    copied first) and on tensors whose data starts 2 bytes past an
    aligned address (copied first): bit for bit the contiguous call's
    gradients, and within TOLS of the plain backward."""
    B, S, H, KH, hd = 2, 200, 4, 2, 64
    dt = torch.bfloat16
    q, do = (rand(rng, (B, S, H, hd), dt, dev) for _ in range(2))
    k, v = (rand(rng, (B, S, KH, hd), dt, dev) for _ in range(2))
    o, lse = flash_kernel.flash_attention_fwd(q, k, v, with_lse=True)
    want = flash_kernel.flash_attention_bwd(q, k, v, o, lse, do)
    ref = flash_attention_bwd_ref(q, k, v, o, lse, do, q_chunk=64)

    def padded(t, pad):
        wide = torch.zeros((*t.shape[:3], hd + pad), dtype=dt, device=dev)
        wide[..., :hd] = t
        return wide[..., :hd]

    def shifted(t):                        # data 2 bytes past alignment
        flat = torch.empty(t.numel() + 1, dtype=dt, device=dev)[1:]
        return flat.view(t.shape).copy_(t)
    errs = []
    for what, make in (("rows of hd + 8", lambda t: padded(t, 8)),
                       ("rows of hd + 4", lambda t: padded(t, 4)),
                       ("2-byte offset", shifted)):
        args = [make(t) for t in (q, k, v, o)] + [lse, make(do)]
        got = flash_kernel.flash_attention_bwd(*args)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"flash bwd {what}: gradients differ from "
                                 f"the contiguous call's")
        errs.append(max(check_close(f"flash bwd {what} d{n}", a, b,
                                    TOLS[dt], TOLS[dt])
                        for n, a, b in zip("qkv", got, ref)))
    log(f"flash bwd strided (rows of {hd} + 8, read by TMA through their "
        f"strides), misaligned (rows of {hd} + 4; a 2-byte offset; both "
        f"copied): bit-identical to the contiguous call; vs plain max abs "
        f"err {max(errs):.3e}")


def check_flash_bwd_mla_layouts(rng, dev, B=TRAIN_B, S=1024, H=16):
    """The backward at deepseek-v2-lite's head dims on q/k/v laid out as
    ``mla_prefill`` makes them (k a cat of the per-head nope part and the
    broadcast rope part, v a reshape of the latent's up-projection, q a
    view into rows of 200): bit for bit the gradients of contiguous
    copies, and within TOLS of the plain backward. Returns the max abs
    error."""
    dt = torch.bfloat16
    kn = rand(rng, (B, S, H, 128), dt, dev)
    kr = rand(rng, (B, S, 1, 64), dt, dev)
    k = torch.cat([kn, kr.expand(B, S, H, 64)], -1)
    lat = rand(rng, (B, S, 512), dt, dev)
    v = (lat @ rand(rng, (512, H * 128), dt, dev, 512 ** -0.5)) \
        .reshape(B, S, H, 128)
    q = rand(rng, (B, S, H, 192 + 8), dt, dev)[..., :192]
    do = rand(rng, (B, S, H, 128), dt, dev)
    scale = 192 ** -0.5
    o, lse = flash_kernel.flash_attention_fwd(q, k, v, scale=scale,
                                              with_lse=True)
    want = flash_kernel.flash_attention_bwd(q.contiguous(), k.contiguous(),
                                            v.contiguous(), o, lse, do,
                                            scale=scale)
    got = flash_kernel.flash_attention_bwd(q, k, v, o, lse, do, scale=scale)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("flash bwd MLA layouts: not the contiguous "
                             "call's bits")
    ref = flash_attention_bwd_ref(q, k, v, o, lse, do, scale=scale,
                                  q_chunk=64)
    e = max(check_close(f"flash bwd MLA layouts d{n}", a, b, TOLS[dt],
                        TOLS[dt]) for n, a, b in zip("qkv", got, ref))
    log(f"flash bwd MLA layouts q/k {(B, S, H, 192)} v 128 (k a cat with "
        f"the broadcast rope part, v a reshape, q rows of 200): "
        f"bit-identical to contiguous copies; vs plain max abs err {e:.3e}")
    return e


def paged_split_ref(q, kp, vp, table, lens):
    plan = paged_kernel.plan(table.shape[1], kp.shape[1],
                             q.shape[1] // kp.shape[2], q.shape[2], q.dtype)
    return paged_attention_split_ref(q, kp, vp, table, lens,
                                     n_split=plan["n_split"],
                                     row_tiles=plan["row_tiles"])


def check_paged_row_tiles(rng, dev, G, KH, hd=128, page=lm.PAGE_SIZE,
                          nblk=34):
    """The query rows of a KV head in the kernel's row tiles (B 4, 34
    pages of 16) against the plain version and the split-merge plain
    version of the same tiles; a zero-length row equal to the mean of V
    over the table's slots. Returns the largest error."""
    B, dt = BATCH, torch.bfloat16
    npool = B * nblk
    q = rand(rng, (B, G * KH, hd), dt, dev)
    kp = rand(rng, (npool, page, KH, hd), dt, dev)
    vp = rand(rng, (npool, page, KH, hd), dt, dev)
    table = torch.from_numpy(rng.permutation(npool).reshape(B, nblk)
                             .astype(np.int32)).to(dev)
    lens = torch.tensor([nblk * page - 1, 0, 300, 17], dtype=torch.int32,
                        device=dev)
    tol = TOLS[dt]
    plain = paged_ops.paged_attention_ref(q, kp, vp, table, lens)
    mean_v = vp[table[1].long()].float().reshape(nblk * page, KH, hd) \
        .mean(0).repeat_interleave(G, dim=0)
    plan = paged_kernel.plan(nblk, page, G, hd, dt)
    out = paged_kernel.paged_attention(q, kp, vp, table, lens)
    split = paged_attention_split_ref(q, kp, vp, table, lens,
                                      n_split=plan["n_split"],
                                      row_tiles=plan["row_tiles"])
    what = f"paged row tiles G={G} KH={KH}"
    worst = max(check_close(what, out, plain, tol, tol),
                check_close(what + " vs split-merge plain", out, split,
                            tol, tol),
                check_close(what + " zero length vs mean of V", out[1],
                            mean_v, tol, tol))
    log(f"paged  row tiles G={G} KH={KH} hd={hd} ({plan['row_tiles']} "
        f"tiles of {plan['rows_per_tile']}): vs plain and split-merge "
        f"plain, a zero-length row vs the mean of V: max abs err "
        f"{worst:.3e} (tol {tol})")
    return worst


def check_paged_lse(rng, dev):
    """The paged kernel's (out, lse) against the plain version's, bf16 and
    fp32, at hd 64 (G 1), qwen2-vl-2b's G 6 and granite-34b's G 48 (row
    tiles), 34 pages of 16 under a permuted table, one zero-length row:
    out within TOLS (PAGED_TOL_F32) and bit-identical to the launch
    without lse, lse within LSE_TOL (absolute and relative), the
    zero-length row's lse <= -1e30. Returns the largest out error."""
    worst = 0.0
    B, page, nblk = BATCH, lm.PAGE_SIZE, 34
    for H, KH, hd in ((32, 32, 64), (12, 2, 128), (48, 1, 128)):
        for dt, tol in ((torch.float32, PAGED_TOL_F32),
                        (torch.bfloat16, TOLS[torch.bfloat16])):
            npool = nblk * B + 4
            q = rand(rng, (B, H, hd), dt, dev)
            kp = rand(rng, (npool, page, KH, hd), dt, dev)
            vp = rand(rng, (npool, page, KH, hd), dt, dev)
            table = torch.from_numpy(rng.permutation(npool)[:B * nblk]
                                     .reshape(B, nblk).astype(np.int32)).to(dev)
            lens_np = rng.integers(1, nblk * page + 1, B).astype(np.int32)
            lens_np[0] = 0
            lens = torch.from_numpy(lens_np).to(dev)
            out, lse = paged_kernel.paged_attention(q, kp, vp, table, lens,
                                                    with_lse=True)
            plain = paged_kernel.paged_attention(q, kp, vp, table, lens)
            what = f"paged +lse B={B} H={H} KH={KH} hd={hd} {str(dt)[6:]}"
            if not torch.equal(out, plain):
                raise AssertionError(f"{what}: out with lse is not the bits "
                                     f"of the launch without it")
            ref_o, ref_lse = paged_ops.paged_attention_ref(
                q.cpu(), kp.cpu(), vp.cpu(), table.cpu(), lens.cpu(),
                with_lse=True)
            e = check_close(what, out, ref_o.to(dev), tol, tol)
            if not bool((lse[0] <= -1e30).all()):
                raise AssertionError(f"{what}: the zero-length row's lse "
                                     f"{lse[0].tolist()} > -1e30")
            el = check_close(f"{what} lse", lse[1:], ref_lse[1:].to(dev),
                             LSE_TOL, LSE_TOL)
            log(f"{what}: out max abs err {e:.3e} (tol {tol}), bits equal to "
                f"the launch without lse; lse max abs err {el:.3e} (tol "
                f"{LSE_TOL}); zero-length row lse {float(lse[0].max()):.3e}")
            worst = max(worst, e)
    return worst


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


def check_paged_decode_lengths(rng, dev, H=32, KH=32, hd=64):
    """Every length a serving decode step reads (513 .. 543: 33 and 34
    pages of 16) at a model's shape (stablelm's by default), against both
    plain versions. Returns the largest error."""
    B = BATCH
    q = rand(rng, (B, H, hd), torch.bfloat16, dev)
    n_pages = B * MAX_LEN // lm.PAGE_SIZE
    kp = rand(rng, (n_pages, lm.PAGE_SIZE, KH, hd), torch.bfloat16, dev)
    vp = rand(rng, (n_pages, lm.PAGE_SIZE, KH, hd), torch.bfloat16, dev)
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
        f"H={H} KH={KH} hd={hd}): max abs err {worst:.3e} against both "
        f"plain versions")
    return worst


def check_tile_rule():
    """The tile rule as compiled into the bf16 backward kernels against
    ref.tile_kinds: ragged S and Sk, S != Sk, windows, the kernels' tiles
    (64 x 64) and others."""
    n = 0
    for S in (1, 63, 64, 65, 127, 129, 200, 257, 513):
        for Sk in (1, 64, 100, 129, 300, 513):
            for qt, kt in ((64, 64), (64, 128), (128, 64), (16, 32)):
                for causal in (False, True):
                    for win in (0, 1, 48, 100, 257):
                        got = flash_kernel.tile_kinds(S, Sk, qt, kt, causal,
                                                      win).numpy()
                        want = tile_kinds(S, Sk, qt, kt, causal, win)
                        if not np.array_equal(got, want):
                            raise AssertionError(
                                f"tile rule {(S, Sk, qt, kt, causal, win)}: "
                                f"kernel {got.tolist()} != ref "
                                f"{want.tolist()}")
                        n += 1
    log(f"flash bwd tile rule: the kernels' copy equals ref.tile_kinds in "
        f"{n} cases")


def moe_slot_shapes():
    """The MoE slot kernel's calls in the benchmark's cells, (label, BG, N,
    Ee, C): deepseek-v2-lite's 16k prompt in one group, its decode step
    (32 tokens routed jointly, one group), its prefill of 32 x 512 and its
    training groups (2 x 4096 in 16 groups of 256), mixtral's decode step
    (16 tokens, 16 sub-experts, 4 slots a token), and 32 groups of 6."""
    ds, mx = get_config("deepseek-v2-lite-16b"), get_config("mixtral-8x22b")
    cap = moe_mod.capacity
    return [("prefill 16k", 1, 16384 * 6, 64, cap(ds, 16384)),
            ("32 groups of 6", 32, 6, 64, 8),
            ("decode b32", 1, 32 * 6, 64, cap(ds, 32)),
            ("mixtral decode b16", 1, 16 * 4, 16, cap(mx, 16)),
            ("prefill 32 x 512", 32, 512 * 6, 64, cap(ds, 512)),
            ("train 2 x 4096", 32, 256 * 6, 64, cap(ds, 256))]


def check_moe_slots(rng, dev):
    """The MoE slot kernel bit for bit its plain version (the one-hot
    cumsum) at the cells' calls, experts drawn uniformly and all on one
    expert; a second call gives the same bits."""
    for label, BG, N, Ee, C in moe_slot_shapes():
        for draw in ("uniform", "one expert"):
            eid = torch.from_numpy(rng.integers(0, Ee, (BG, N))).to(dev) \
                if draw == "uniform" else \
                torch.full((BG, N), Ee - 1, dtype=torch.int64, device=dev)
            got = slots_kernel.moe_slots(eid, Ee, C)
            want = moe_slots_ref(eid, Ee, C)
            again = slots_kernel.moe_slots(eid, Ee, C)
            for what, a, b, c in zip(("slot", "keep", "dest", "kept"), got,
                                     want, again):
                if a.dtype != b.dtype or not torch.equal(a, b) \
                        or not torch.equal(a, c):
                    raise AssertionError(f"moe_slots {label} ({draw}): "
                                         f"{what} differs")
            log(f"  moe_slots {label} (BG {BG}, N {N}, Ee {Ee}, C {C}, "
                f"{draw}): bit-identical, kept {int(got[1].sum())} of "
                f"{BG * N}")


ADAMW_CONSTS = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


def adamw_train_shapes():
    """The leaf shapes of deepseek-v2-lite's training configuration
    (``train_config``: 29 fp32 leaves, 2.84 B elements, the benchmark's
    ``dsv2lite-train-4k``)."""
    return [tuple(a.shape) for a in tree_leaves(lm.abstract_params(
        train_config("deepseek-v2-lite-16b")))]


def check_adamw(dev):
    """The AdamW update kernel bit for bit its plain version given the same
    scale, lr and bias corrections (fp32 and bf16 p and g, leaves of 1 to
    3 dims, sizes no multiple of 4, a view off the vector boundary), and
    the norm within 1e-6 of the plain global norm; then at the training
    configuration's own leaves: the norm over the whole set, and the
    update leaf by leaf against clones, bit for bit."""
    gen = torch.Generator(dev).manual_seed(0)
    shapes = [(3,), (4097,), (33, 65), (2, 3, 4099), (64, 2048)]
    t = torch.tensor(3.0, device=dev)
    lr, bc1, bc2 = (torch.tensor(3e-3, device=dev), 1 - torch.pow(0.9, t),
                    1 - torch.pow(0.95, t))

    def update_both(p, g, m, v, scale):
        ref = [[x.clone() for x in xs] for xs in (p, m, v)]
        adamw_kernel.adamw_update_(p, g, m, v, scale, lr, bc1, bc2,
                                   **ADAMW_CONSTS)
        adamw_update_ref(ref[0], g, ref[1], ref[2], scale, lr, bc1, bc2,
                         **ADAMW_CONSTS)
        return all(torch.equal(a, b) for xs, ys in zip((p, m, v), ref)
                   for a, b in zip(xs, ys))

    def norm_err(g):
        gn, scale = adamw_kernel.adamw_norm(adamw_kernel.adamw_sumsq(g), 1.0)
        return abs(float(gn) / float(grad_norm_ref(g)) - 1), scale

    for dt in (torch.float32, torch.bfloat16):
        for off in (0, 1):
            def leaf(shape, dtype, k=1.0):
                n = int(np.prod(shape))
                return (k * torch.randn(n + off, generator=gen, device=dev)) \
                    .to(dtype)[off:].view(shape)
            p = [leaf(s, dt) for s in shapes]
            g = [leaf(s, dt, 3.0) for s in shapes]
            m = [leaf(s, torch.float32, 0.1) for s in shapes]
            v = [leaf(s, torch.float32, 0.1).square() for s in shapes]
            rel, scale = norm_err(g)
            same = update_both(p, g, m, v, scale)
            if not same or rel > 1e-6:
                raise AssertionError(f"adamw {dt} offset {off}: update "
                                     f"bit-identical {same}, norm rel err "
                                     f"{rel:.2e}")
            log(f"  adamw {dt} (offset {off}): update bit-identical, norm "
                f"rel err {rel:.2e}")
    shapes = adamw_train_shapes()
    g = [torch.randn(s, generator=gen, device=dev) for s in shapes]
    rel, scale = norm_err(g)
    same = []
    for s, gi in zip(shapes, g):
        p, m = (torch.randn(s, generator=gen, device=dev) for _ in range(2))
        same.append(update_both([p], [gi], [m], [m.square()], scale))
        del p, m
    n = sum(x.numel() for x in g)
    del g
    free_card()
    if not all(same) or rel > 1e-6:
        raise AssertionError(f"adamw at the training leaves: update "
                             f"bit-identical {same}, norm rel err {rel:.2e}")
    log(f"  adamw at deepseek-v2-lite's training leaves ({len(shapes)} fp32 "
        f"leaves, {n} elements): update bit-identical leaf by leaf, norm "
        f"rel err {rel:.2e}")


def phase_kernels_vs_plain(dev):
    rng = np.random.default_rng(0)
    check_moe_slots(rng, dev)
    check_adamw(dev)
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
    # the bf16 backward's tile edges (64-row q tiles, 128-key dK/dV CTAs)
    for B, S, Sk, H, KH, hd, win in FLASH_BWD_EDGES:
        check_flash_bwd(rng, dev, B, S, H, KH, hd, torch.bfloat16, win=win,
                        Sk=Sk)
    check_flash_bwd_strided(rng, dev)
    check_tile_rule()

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
    check_paged_lse(rng, dev)
    # qwen2-vl-2b's decode: G = 6 query heads a KV head (not a power of
    # two) at hd 128, 34 pages of 16
    check_paged_permuted(rng, dev, BATCH, 12, 2, 128, lm.PAGE_SIZE, 34)
    qwen = {"paged_attention": check_paged_decode_lengths(rng, dev, 12, 2,
                                                          128)}
    # mixtral-8x22b's decode: 48 query heads over 8 KV heads (G = 6) at hd
    # 128, 34 pages of 16
    check_paged_permuted(rng, dev, BATCH, 48, 8, 128, lm.PAGE_SIZE, 34)
    mixtral = {"paged_attention": check_paged_decode_lengths(rng, dev, 48, 8,
                                                             128)}
    # deepseek-v2-lite's prefill: the flash forward at q/k 192, v 128 (16
    # heads), bf16 and fp32, ragged last tiles, MLA's layouts
    for dt in (torch.float32, torch.bfloat16):
        for B, S in ((1, 512), (1, 513), (2, 130)):
            check_flash_mla(rng, dev, B, S, dt)
    mla = {"flash_attention_fwd": max(check_flash_mla(rng, dev, BATCH, PROMPT,
                                                      torch.bfloat16),
                                      check_flash_mla_layouts(rng, dev))}
    # deepseek-v2-lite's training: the flash backward at q/k 192, v 128
    # (scale 1/sqrt(192) as the model passes it, the wrappers' default),
    # ragged last tiles, GQA 4:1, MLA's layouts; two calls bit-identical
    for dt in (torch.float32, torch.bfloat16):
        for B, S, H, KH in ((1, 512, 16, 16), (1, 513, 16, 16),
                            (2, 130, 16, 16), (2, 200, 8, 2)):
            check_flash_bwd(rng, dev, B, S, H, KH, 192, dt, hdv=128)
    check_flash_bwd_mla_layouts(rng, dev)
    # granite-34b's, yi-34b's and deepseek-67b's decode: G = 48 over one
    # KV head (6 row tiles of 8), 7 and 8 at hd 128, 34 pages of 16; and
    # their prefill, the flash forward at the same heads
    dense = {}
    for label, G, KH in DENSE_LARGE:
        check_paged_permuted(rng, dev, BATCH, G * KH, KH, 128,
                             lm.PAGE_SIZE, 34)
        dense[label] = {"paged_attention": max(
            check_paged_row_tiles(rng, dev, G, KH),
            check_paged_decode_lengths(rng, dev, G * KH, KH, 128)),
            "flash_attention_fwd": check_flash(
                rng, dev, BATCH, PROMPT, G * KH, KH, 128, torch.bfloat16)}
    check_paged_row_tiles(rng, dev, 9, 2)        # tiles of 5 and 4

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
    # the SSD backward kernel: the shapes above and the tensor-core
    # instance's hp x ns sweep, both dtypes, two calls bit-identical; the
    # full op's gradient (an initial state, a padded S) through it
    for dtype in (torch.float32, torch.bfloat16):
        for shape in SSD_BWD_SHAPES[:-2]:
            check_ssd_bwd(rng, dev, *shape, dtype)
        for hp in (16, 32):
            for ns in (8, 16, 32, 64, 128):
                check_ssd_bwd(rng, dev, 2, 256, 3, hp, ns, 128, dtype)
        check_ssd_grad(rng, dev, 2, 100, 4, 32, 16, 32, dtype)
        check_ssd_grad(rng, dev, 1, 300, 3, 64, 64, 256, dtype)
        # slow decay: exp(tot), w_j and the far tiles' L of size 0.1 to 1
        for shape in SSD_BWD_SLOW_SHAPES:
            check_ssd_bwd(rng, dev, *shape, dtype, SLOW_DT)
        check_ssd_grad(rng, dev, 1, 600, 3, 64, 64, 256, dtype, SLOW_DT)

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
    # qwen2-vl-2b's prefill: GQA 6:1 at hd 128, forward (with and without
    # lse) and backward
    qwen["flash_attention_fwd"] = check_flash(rng, dev, BATCH, PROMPT, 12, 2,
                                              128, torch.bfloat16)
    # mixtral-8x22b's prefill: GQA 6:1 over 8 KV heads at hd 128, window
    # 4096
    mixtral["flash_attention_fwd"] = check_flash(
        rng, dev, BATCH, PROMPT, 48, 8, 128, torch.bfloat16, win=4096)
    check_flash_bwd(rng, dev, BATCH, PROMPT, 12, 2, 128, torch.bfloat16)
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
    # the backward at the training calls of zamba2-2.7b and mamba2-130m
    # (and with slow decay)
    for dtype in (torch.float32, torch.bfloat16):
        check_ssd_bwd(rng, dev, *SSD_BWD_SHAPES[-1], dtype)
        check_ssd_bwd(rng, dev, *SSD_BWD_SHAPES[-1], dtype, SLOW_DT)
        check_ssd_bwd(rng, dev, *SSD_BWD_SHAPES[-2], dtype, SLOW_DT)
        e = check_ssd_bwd(rng, dev, *SSD_BWD_SHAPES[-2], dtype)
    errs["ssd_chunk_bwd"] = e
    free_card()
    # the training shape: stablelm-1.6b's attention at 2 x 4096
    errs["flash_attention_fwd train"], errs["flash_attention_bwd"] = \
        check_flash_bwd(rng, dev, TRAIN_B, TRAIN_S, 32, 32, 64,
                        torch.bfloat16, q_chunk=512)
    free_card()
    # qwen2-vl-2b's training call: GQA 6:1 at hd 128, 2 x 4096 (its dK/dV
    # CTAs: 2 KV heads x 32 key tiles x 2 = 128 for 132 SMs, each summing 6
    # query heads)
    qwen["flash_attention_fwd train"], qwen["flash_attention_bwd"] = \
        check_flash_bwd(rng, dev, TRAIN_B, TRAIN_S, 12, 2, 128,
                        torch.bfloat16, q_chunk=512)
    free_card()
    # mixtral-8x22b's training call: GQA 6:1 at hd 128, window 4096
    mixtral["flash_attention_fwd train"], mixtral["flash_attention_bwd"] = \
        check_flash_bwd(rng, dev, TRAIN_B, TRAIN_S, 48, 8, 128,
                        torch.bfloat16, win=4096, q_chunk=512)
    free_card()
    # deepseek-v2-lite's training call: 16 heads at q/k 192, v 128, causal,
    # 2 x 4096, fp32 then bf16
    check_flash_bwd(rng, dev, TRAIN_B, TRAIN_S, 16, 16, 192, torch.float32,
                    q_chunk=512, hdv=128)
    free_card()
    mla["flash_attention_fwd train"], mla["flash_attention_bwd"] = \
        check_flash_bwd(rng, dev, TRAIN_B, TRAIN_S, 16, 16, 192,
                        torch.bfloat16, q_chunk=512, hdv=128)
    torch.cuda.synchronize()
    return errs, {"qwen2_vl": qwen, "mixtral": mixtral, "deepseek_mla": mla,
                  **dense}


# ---------------------------------------------------------------------------
# phase 3: the main paths
# ---------------------------------------------------------------------------

def slot_launches(cfg, S):
    """The slot kernel's launches in one forward of the MoE layers over
    rows of S tokens: each layer's dispatch launches once, twice when a
    group's slots span more than one of the kernel's tiles."""
    if cfg.moe is None:
        return 0
    slots = S // moe_mod.groups(S) * cfg.moe.top_k * moe_mod.expert_split(cfg)
    return (cfg.n_layers - cfg.moe.first_k_dense) \
        * (1 + (slots > slots_kernel.tile()))


def expected_launches(cfg):
    """What ``ServeLoop.generate`` launches: the prefill of BATCH prompts of
    PROMPT tokens, then NEW - 1 decode steps (a step routes its BATCH
    tokens as one group)."""
    L, steps = cfg.n_layers, NEW - 1
    out = {n: 0 for n in KERNELS}
    out["moe_slots"] = slot_launches(cfg, PROMPT) \
        + steps * slot_launches(cfg, BATCH)
    if cfg.family in ATTN_ONLY:
        out.update(flash_attention_fwd=L,
                   paged_attention=0 if cfg.mla else L * steps)
        return out
    G = L // cfg.attn_every if cfg.family == "hybrid" else 0
    out.update(flash_attention_fwd=G, paged_attention=G * steps,
               ssd_chunk_call=L * (1 + steps))
    return out


def train_launches(cfg, steps, optimizer=True):
    """What ``steps`` train steps launch: each microbatch runs every layer's
    forward once, and again in the backward when the layer is
    rematerialised, and its backward once; attention is each dense layer,
    or the tied block after every ``attn_every`` Mamba2 layers; the slot
    kernel runs in each MoE layer's forward; with the ``optimizer``, each
    step's AdamW sums the squares of the fp32 gradients and updates the
    leaves once a table of ``table_leaves()`` leaves, and finishes the
    norm once."""
    mb, fwd = max(cfg.microbatches, 1), 2 if cfg.remat else 1
    L = cfg.n_layers
    attn_calls = {"dense": L, "vlm": L, "audio": L, "moe": L,
                  "hybrid": L // max(cfg.attn_every, 1), "ssm": 0}[cfg.family]
    ssd_calls = 0 if cfg.family in ATTN_ONLY else L
    n = steps * mb
    tables = -(-len(tree_leaves(lm.abstract_params(cfg)))
               // adamw_kernel.table_leaves())
    return {"flash_attention_fwd": fwd * attn_calls * n,
            "flash_attention_bwd": attn_calls * n, "paged_attention": 0,
            "ssd_chunk_call": fwd * ssd_calls * n,
            "ssd_chunk_bwd": ssd_calls * n,
            "moe_slots": fwd * slot_launches(cfg, TRAIN_S) * n,
            "adamw_sumsq": tables * steps * optimizer,
            "adamw_norm": steps * optimizer,
            "adamw_update_": tables * steps * optimizer}


def phase_ring_cache(dev, window=None, steps=33):
    """mixtral's sliding-window ring cache through the paged kernel's
    identity table: the smoke config (window 64, or ``window``; head_dim
    32, since the kernels take no 16) in bf16, top-2 of 4 experts at
    capacity 8.0 (no drops), a prompt of two windows, then ``steps``
    decode steps, each within RING_TOL of a full forward. A window that
    is not a whole number of pages (40: 3 pages a sequence) makes a cache
    whose ring modulus, its logical length, is not the pages' length;
    window + 1 steps then write every slot and wrap. A router
    near-tie that bf16 rounds one way in the prefill or a decode step and
    the other way in the forward moves a token to another expert, which
    says nothing of the ring: the forward takes the prefill's and the
    decode steps' routes (``MoERoutes``), and its own may differ from them
    only by a near-tie (FLIP_GAPS; a wider gap fails). The gaps are
    printed. ``tests/test_torch_gpu.py`` runs this function too."""
    cfg = get_smoke_config("mixtral-8x22b").replace(head_dim=32)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0),
                      swa_window=window or cfg.swa_window)
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0),
                            device=dev)
    S0 = 2 * cfg.swa_window
    S1 = S0 + steps
    L, K = cfg.n_layers, cfg.moe.top_k
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, S1)).astype(np.int32)).to(dev)
    atol, rtol = RING_TOL
    before = {n: fn.launches for n, fn in KERNELS.items()}
    with torch.inference_mode():
        with MoERoutes() as pre:
            cache = lm.forward(cfg, params, {"tokens": toks[:, :S0]},
                               collect_cache=True)[2]
        cache = lm.grow_cache(cfg, lm.prefill_cache(cfg, cache, S0), S1)
        if cache["k"].shape[2] != cfg.swa_window:
            raise AssertionError(f"ring cache of {cache['k'].shape[2]} "
                                 f"slots, not {cfg.swa_window}")
        logits = []
        with MoERoutes() as dec:
            for pos in range(S0, S1):
                lg, cache = lm.decode_step(cfg, params, cache,
                                           toks[:, pos:pos + 1], pos)
                logits.append(lg)

        def as_served(i, probs, ids):         # layer i of the forward
            ids = ids.clone()
            ids[:, 0, :S0] = pre.calls[i][1][:, 0]
            for pos in range(S0, S1):
                ids[:, 0, pos] = dec.calls[(pos - S0) * L + i][1][0, 0]
            return ids
        with MoERoutes(force=as_served) as fwd:
            full, _, _ = lm.forward(cfg, params, {"tokens": toks})
        worst = max(check_close(f"ring cache: decode at {pos} vs forward",
                                lg, full[:, pos], atol, rtol)
                    for pos, lg in zip(range(S0, S1), logits))
    torch.cuda.synchronize()
    if not len(pre.calls) == len(fwd.calls) == L or \
            len(dec.calls) != L * (S1 - S0):
        raise AssertionError(f"ring cache: {len(pre.calls)} / "
                             f"{len(dec.calls)} / {len(fwd.calls)} router "
                             f"calls")
    forced = [as_served(i, probs, ids)[:, 0].reshape(-1, K)
              for i, (probs, ids) in enumerate(fwd.calls)]
    flips = route_flips(fwd.calls, forced, K,
                        lambda t: t[:, 0].reshape(-1, t.shape[-1]),
                        FLIP_GAPS[cfg.compute_dtype])
    n = {k: fn.launches - before[k] for k, fn in KERNELS.items()}
    want = (2 * cfg.n_layers, cfg.n_layers * (S1 - S0),
            slot_launches(cfg, S0) + slot_launches(cfg, S1)
            + (S1 - S0) * slot_launches(cfg, toks.shape[0]))
    if (n["flash_attention_fwd"], n["paged_attention"],
            n["moe_slots"]) != want:
        raise AssertionError(f"ring cache: launches {n}, not {want}")
    log(f"ring cache [mixtral-8x22b smoke, hd 32, window {cfg.swa_window}, "
        f"top-{K} of {cfg.moe.n_experts}, bf16]: prompt {S0}, "
        f"decode steps {S0}..{S1 - 1} over the {cfg.swa_window}-slot ring "
        f"({lm.whole_pages(cfg.swa_window) // lm.PAGE_SIZE} pages a "
        f"sequence) through the paged kernel: max abs err vs the forward "
        f"{worst:.3e} "
        f"(atol {atol} rtol {rtol}); the forward took the served routes, "
        f"its own differing in {len(flips)} of {L * 2 * S1} (layer, token) "
        f"routes, all near-ties (relative gaps "
        f"{[f'{g:.2e}' for _, _, g in flips]} <= "
        f"{FLIP_GAPS[cfg.compute_dtype]:.2e}); launches flash {want[0]}, "
        f"paged {want[1]}, moe_slots {want[2]}")


def serve_config(arch):
    """The served config: full width; the moe family and the configs cut
    in depth with bf16 weights, at SERVE_LAYERS' depth."""
    cfg = get_config(arch)
    if cfg.family == "moe" or arch in SERVE_LAYERS:
        cfg = cfg.replace(param_dtype="bfloat16",
                          n_layers=SERVE_LAYERS.get(arch, cfg.n_layers))
    return cfg


def train_config(arch):
    """The trained config: full width; mixtral and deepseek-v2-lite at
    TRAIN_LAYERS' depth in one microbatch."""
    cfg = get_config(arch)
    if arch in TRAIN_LAYERS:
        cfg = cfg.replace(n_layers=TRAIN_LAYERS[arch], microbatches=1)
    return cfg


def describe(cfg):
    """The config's widths, for the log."""
    out = (f"H={cfg.n_heads} KH={cfg.n_kv_heads} hd={cfg.hd} "
           f"d_ff={cfg.d_ff} " if cfg.family != "ssm" else "")
    if cfg.swa_window:
        out += f"window={cfg.swa_window} "
    if cfg.mla is not None:
        m = cfg.mla
        out += (f"MLA lora={m.kv_lora_rank} q/k {m.qk_nope_head_dim}+"
                f"{m.qk_rope_head_dim} v {m.v_head_dim} ")
    if cfg.moe is not None:
        m = cfg.moe
        out += (f"MoE {m.n_experts} experts top-{m.top_k} d_ff_expert="
                f"{m.d_ff_expert} (split {moe_mod.expert_split(cfg)}) shared="
                f"{m.n_shared} first_k_dense={m.first_k_dense} capacity="
                f"{m.capacity_factor} ")
    if cfg.ssm is not None:
        s = cfg.ssm
        out += (f"ssm heads={s.n_heads(cfg.d_model)} headdim={s.headdim} "
                f"d_state={s.d_state} chunk={s.chunk} ")
    if cfg.family == "hybrid":
        out += f"attn_every={cfg.attn_every} "
    return out


def phase_main_path(dev, arch):
    cfg = serve_config(arch)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, gen, device=dev)
    serve = ServeLoop(cfg, params, max_len=MAX_LEN, device=dev)
    del params
    free_card()
    n_par = sum(t.numel() for t in _leaves(serve.params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(serve.params))
    cut = f" (of {get_config(arch).n_layers})" if arch in SERVE_LAYERS \
        else ""
    log(f"main[{arch}]: {cfg.family} {cfg.n_layers}L{cut}"
        f" d_model={cfg.d_model} {describe(cfg)}vocab={cfg.vocab_size}: "
        f"{n_par / 1e9:.3f} B params ({cfg.param_dtype}, {n_bytes / 1e9:.2f} "
        f"GB), built in {time.perf_counter() - t0:.1f} s")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, prompt_shape(cfg, BATCH, PROMPT)).astype(np.int32)

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
    if tuple(toks.shape) != prompt_shape(cfg, BATCH, NEW) or \
            not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"{arch}: generated tokens out of range")
    if cfg.family == "moe":
        check_moe_first_decode(dev, arch, cfg, serve, prompts)
        return cfg, serve, prompts, launches

    with torch.inference_mode():
        tokens = torch.from_numpy(prompts).to(dev)
        logits0, cache = serve.prefill(serve.params, {"tokens": tokens})
        full = lm.grow_cache(cfg, cache, MAX_LEN)
        first = logits0[..., :cfg.vocab_size].argmax(-1).to(torch.int32)[:, None]
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
                          step_logits[..., :V], ref[..., :V], atol, rtol)
        agree = (step_logits[..., :V].argmax(-1) == ref[..., :V].argmax(-1))
        same_first = bool(torch.equal(first[:, 0], toks[:, 0]))
        same_second = (step_logits[..., :V].argmax(-1).to(torch.int32)
                       == toks[:, 1])
        del fwd_logits, full, cache
    log(f"main[{arch}]: first decode step vs forward over prompt+token: max "
        f"abs err {err:.3e} (|ref| max {ref.float().abs().max().item():.3f}; "
        f"atol {atol} rtol {rtol}); greedy agreement "
        f"{int(agree.sum())}/{agree.numel()}; generate's token 0 reproduced: "
        f"{same_first}, token 1: {int(same_second.sum())}/"
        f"{same_second.numel()}")
    if cfg.family == "vlm":
        check_vlm_prefill_embeds(dev, arch, cfg, serve)
    if arch == ARCHS[0]:
        check_any_cache_length(arch, cfg, serve, prompts)
    return cfg, serve, prompts, launches


def check_any_cache_length(arch, cfg, serve, prompts):
    """A cache of ANY_LEN positions (not a whole number of pages: the
    cache is allocated in whole pages and read through them) gives the
    tokens of a cache of MAX_LEN: ``generate`` of ANY_LEN_NEW tokens from
    the same prompts with each. Both caches are 34 pages a sequence and
    decode stays below ANY_LEN, so this shows only that ``init_cache``'s
    view of whole pages is read in place; the ring modulus at a logical
    length that is not whole pages is ``phase_ring_cache`` at
    RING_ANY_LEN's."""
    out = {}
    for n in (ANY_LEN, MAX_LEN):
        serve.max_len = n
        out[n] = serve.generate(prompts, ANY_LEN_NEW)
    serve.max_len = MAX_LEN
    torch.cuda.synchronize()
    if not torch.equal(out[ANY_LEN], out[MAX_LEN]):
        raise AssertionError(f"{arch}: tokens with a cache of {ANY_LEN} "
                             f"differ from a cache of {MAX_LEN}")
    log(f"main[{arch}]: a cache of {ANY_LEN} positions ({ANY_LEN} % "
        f"{lm.PAGE_SIZE} = {ANY_LEN % lm.PAGE_SIZE}, allocated in "
        f"{lm.whole_pages(ANY_LEN) // lm.PAGE_SIZE} pages a sequence): "
        f"{ANY_LEN_NEW} generated tokens x {BATCH} prompts equal to a cache "
        f"of {MAX_LEN}'s")


class MoERoutes:
    """While active, records the router's probabilities and top-k of every
    ``moe_ffn`` call (it wraps the port's ``moe._top_k``): ``calls`` holds
    one (probs fp32, ids) a call, in order, the ids the router chose. With
    ``force``, a function (i, probs, ids) -> ids, the i-th call routes by
    the ids it returns instead (its gates the probabilities there)."""

    def __init__(self, force=None):
        self.force = force

    def __enter__(self):
        self.calls, self._real = [], moe_mod._top_k

        def route(probs, k):
            vals, ids = self._real(probs, k)
            self.calls.append((probs.detach().float(), ids.detach()))
            if self.force is not None:
                ids = self.force(len(self.calls) - 1, probs, ids)
                vals = torch.gather(probs, -1, ids)
            return vals, ids
        moe_mod._top_k = route
        return self

    def __exit__(self, *exc):
        moe_mod._top_k = self._real


def _top_gap(probs, k):
    """The relative gap of the k-th and (k+1)-th largest of ``probs``."""
    top = torch.topk(probs, k + 1).values
    return float((top[k - 1] - top[k]) / top[k - 1])


def route_flips(own, forced, k, where, gap_tol):
    """Where a run's own routes (``own``: MoERoutes.calls) differ from the
    ones it was forced to take (``forced``: (n, k) ids a call), as (call,
    row, relative gap of its k-th and (k+1)-th probabilities); ``where``
    picks the n rows of a call's probs and ids to compare. A gap above
    ``gap_tol`` is a route the rounding cannot explain: it raises."""
    flips = []
    for i, ((probs, ids), b) in enumerate(zip(own, forced)):
        p, a = where(probs), where(ids)
        for n in range(a.shape[0]):
            if set(a[n].tolist()) != set(b[n].tolist()):
                gap = _top_gap(p[n], k)
                if gap > gap_tol:
                    raise AssertionError(
                        f"call {i} row {n}: routed to {a[n].tolist()}, "
                        f"forced to {b[n].tolist()}, {gap:.2e} apart")
                flips.append((i, n, gap))
    return flips


def check_moe_first_decode(dev, arch, cfg, serve, prompts):
    """The first decode step after a prefill against a full forward over
    prompt + token, on a copy of the config with capacity factor
    ceil(E / k) (no slot drops, which the forward's recorded routes
    confirm) and fp32 compute (LOGIT_TOLS' note), on MOE_CHECK_ROWS[arch]
    of the prompts. The forward routes the new token as the decode step
    did, layer by layer (``MoERoutes``), where its own route differs only
    by a near-tie (FLIP_GAPS); a wider difference fails."""
    rows = MOE_CHECK_ROWS[arch]
    factor = float(-(-cfg.moe.n_experts // cfg.moe.top_k))
    ccfg = cfg.replace(compute_dtype="float32", moe=dataclasses.replace(
        cfg.moe, capacity_factor=factor))
    V, K = cfg.vocab_size, cfg.moe.top_k
    split = moe_mod.expert_split(cfg)

    with torch.inference_mode():
        tokens = torch.from_numpy(prompts[:rows]).to(dev)
        logits0, cache = make_prefill_step(ccfg)(serve.params,
                                                 {"tokens": tokens})
        full = lm.grow_cache(ccfg, cache, MAX_LEN)
        del cache
        first = logits0[:, :V].argmax(-1).to(torch.int32)[:, None]
        with MoERoutes() as dec:
            step, _ = lm.decode_step(ccfg, serve.params, full, first, PROMPT)
        del full

        def as_decoded(i, probs, ids):
            ids = ids.clone()
            ids[:, 0, PROMPT] = dec.calls[i][1][0, 0]
            return ids
        with MoERoutes(force=as_decoded) as fwd:
            ref = lm.forward(ccfg, serve.params, {"tokens": torch.cat(
                [tokens, first], dim=1)})[0][:, PROMPT]
        torch.cuda.synchronize()
    n_moe = cfg.n_layers - cfg.moe.first_k_dense
    if not len(dec.calls) == len(fwd.calls) == n_moe:
        raise AssertionError(f"{arch}: {len(dec.calls)} / {len(fwd.calls)} "
                             f"routed layers, not {n_moe}")
    C = moe_mod.capacity(ccfg, PROMPT + 1)
    most = max(int(torch.bincount(ids[b].flatten()).max())
               for _, ids in fwd.calls for b in range(rows))
    if most > C:
        raise AssertionError(f"{arch}: an expert got {most} slots > {C}")
    gap_tol = FLIP_GAPS[ccfg.compute_dtype]
    flips = route_flips(fwd.calls, [ids[0, 0] for _, ids in dec.calls], K,
                        lambda t: t[:, 0, PROMPT], gap_tol)
    for what, t in (("prefill", logits0), ("decode", step), ("forward", ref)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{arch}: {what} logits are not finite")
    atol, rtol = LOGIT_TOLS["moe"]
    err = check_close(f"{arch}: first decode step vs forward (fp32, "
                      f"capacity {factor})", step[:, :V], ref[:, :V], atol,
                      rtol)
    same = (step[:, :V].argmax(-1) == ref[:, :V].argmax(-1))
    subs = f", each of its {split} sub-experts" if split > 1 else ""
    log(f"main[{arch}]: first decode step vs forward over prompt+token, "
        f"{rows} rows, fp32 compute, capacity {factor} (C {C}, the forward's "
        f"most-loaded expert {most} slots a row{subs}); the forward's own "
        f"routes for the new token differ from decode's in "
        f"{len(flips)} of {n_moe * rows} (layer, row) pairs, all near-ties "
        f"(relative gaps {[f'{g:.1e}' for _, _, g in flips]} <= "
        f"{gap_tol}), and it takes decode's: max abs err {err:.3e} (|ref| "
        f"max {ref[:, :V].abs().max().item():.3f}; atol {atol} rtol "
        f"{rtol}); greedy agreement {int(same.sum())}/{rows}")


def prompt_shape(cfg, B, S):
    """(B, S) token ids, audio (B, S, K): K codebook streams a position."""
    return (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)


def vlm_pos3(B, S, dev, grid):
    """(3, B, S) int32 M-RoPE ids: a (t, h, w) patch grid's ids, then text
    positions from the grid's largest id + 1 on all three streams
    (Qwen2-VL's layout)."""
    t, h, w = torch.meshgrid(*(torch.arange(n) for n in grid),
                             indexing="ij")
    img = torch.stack([t.flatten(), h.flatten(), w.flatten()])
    txt = torch.arange(S - img.shape[1]) + img.max() + 1
    one = torch.cat([img, txt.expand(3, -1)], dim=1)
    return one[:, None].expand(3, B, S).to(dev, torch.int32).contiguous()


def vlm_embeds(cfg, B, S, dev, seed):
    """Stand-in patch and text embeddings (the vision frontend is a stub
    in both packages): N(0, 1) in bf16 from a seeded CUDA generator."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((B, S, cfg.d_model), generator=g,
                       device=dev).to(torch.bfloat16)


def check_vlm_prefill_embeds(dev, arch, cfg, serve):
    """qwen2-vl-2b's prefill from patch embeddings with a patch-grid pos3
    (the JAX package's vlm prefill and train input): one flash launch a
    layer, and its last logits are the forward's on the same input bit
    for bit; the same embeddings with three equal streams give other
    logits. Then a decode step at position S (all three M-RoPE streams at
    S, the JAX package's decode) against a forward over the S inputs and
    that token's embedding at (S, S, S)."""
    V = cfg.vocab_size
    with torch.inference_mode():
        emb = vlm_embeds(cfg, BATCH, PROMPT, dev, seed=1)
        pos3 = vlm_pos3(BATCH, PROMPT, dev, VLM_GRID_SERVE)
        batch = {"embeds": emb, "pos3": pos3}
        before = flash_kernel.flash_attention_fwd.launches
        last, cache = serve.prefill(serve.params, batch)
        torch.cuda.synchronize()
        n = flash_kernel.flash_attention_fwd.launches - before
        if n != cfg.n_layers:
            raise AssertionError(f"{arch}: prefill from embeds launched "
                                 f"flash {n} times, not {cfg.n_layers}")
        fwd, _, _ = lm.forward(cfg, serve.params, batch)
        if not torch.equal(last, fwd[:, -1]):
            raise AssertionError(f"{arch}: prefill from embeds differs from "
                                 f"the forward on the same input")
        plain, _, _ = lm.forward(cfg, serve.params, {"embeds": emb})
        moved = float((plain[:, -1] - last).float().abs().max())
        if not moved > 0:
            raise AssertionError(f"{arch}: the patch-grid pos3 changed no "
                                 f"logit")
        full = lm.grow_cache(cfg, cache, MAX_LEN)
        tok = last[:, :V].argmax(-1).to(torch.int32)[:, None]
        step, _ = lm.decode_step(cfg, serve.params, full, tok, PROMPT)
        row = lm.embed_tokens(cfg, serve.params, tok, cfg.compute_dt())
        at = torch.full((3, BATCH, 1), PROMPT, dtype=torch.int32, device=dev)
        ref, _, _ = lm.forward(cfg, serve.params, {
            "embeds": torch.cat([emb, row], 1),
            "pos3": torch.cat([pos3, at], 2)})
        atol, rtol = LOGIT_TOLS["vlm"]
        err = check_close(f"{arch}: decode after an embeds prefill vs "
                          f"forward", step[:, :V], ref[:, -1, :V], atol, rtol)
        del full, cache, fwd, plain, ref
    log(f"main[{arch}]: prefill from embeds {tuple(emb.shape)} with a "
        f"{VLM_GRID_SERVE} patch-grid pos3: {n} flash launches, last logits "
        f"bit-identical to the forward's; three equal streams move them by "
        f"up to {moved:.3f}; a decode step at (S, S, S) vs the forward over "
        f"S + 1 inputs: max abs err {err:.3e} (atol {atol} rtol {rtol})")


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def corpus_tokens(cfg):
    """Tokens of a run's synthetic corpus: 64 batches of ring reads."""
    return 64 * TRAIN_B * (TRAIN_S * (cfg.n_codebooks or 1) + 1)


def train_data(cfg, corpus, dev):
    """The batches a training run reads, through a RingLoader over
    ``corpus``: tokens and labels; for vlm, stand-in patch embeddings with
    a patch-grid pos3 and the ring's labels; for audio, (B, S, K) tokens
    and labels from ring reads of K·S tokens a row, reshaped (driver code:
    neither package has a codebook loader)."""
    K = cfg.n_codebooks
    loader = RingLoader(TokenStore(corpus), batch=TRAIN_B,
                        seq=TRAIN_S * (K or 1))
    if cfg.family == "vlm":
        pos3 = vlm_pos3(TRAIN_B, TRAIN_S, dev, VLM_GRID_TRAIN)
        return ({"embeds": vlm_embeds(cfg, TRAIN_B, TRAIN_S, dev, 100 + i),
                 "pos3": pos3, "labels": b["labels"]}
                for i, b in enumerate(loader))
    if K:
        return ({k: v.reshape(TRAIN_B, TRAIN_S, K) for k, v in b.items()}
                for b in loader)
    return iter(loader)


def card_batch(cfg, corpus, dev):
    return {k: torch.as_tensor(v, device=dev)
            for k, v in next(train_data(cfg, corpus, dev)).items()}


def watched(cfg, params):
    """Parameters whose change over the run is checked: the embedding, the
    final norm, and per family the first and last layers' matrices (a
    Mamba2 layer's wx and A_log, whose gradient only the SSD backward
    gives; the tied attention block)."""
    lay = params["layers"]
    out = {"embed": params["embed"][:256], "final_norm": params["final_norm"]}
    if cfg.family in ATTN_ONLY:
        if cfg.family == "vlm":          # trained on embeds: the head moves
            out["head[:, :256]"] = params["head"][:, :256]
        ffn = "moe" if cfg.family == "moe" else "mlp"
        out.update({"wq[0]": lay["attn"]["wq"][0],
                    f"{ffn} w2[{cfg.n_layers - 1}]": lay[ffn]["w2"][-1]})
        if cfg.family == "moe":
            out[f"router[{cfg.n_layers - 1}]"] = lay["moe"]["router"][-1]
        return out
    out.update({"wx[0]": lay["wx"][0],
                f"A_log[{cfg.n_layers - 1}]": lay["A_log"][-1]})
    if cfg.family == "hybrid":
        out["shared wq"] = params["shared_attn"]["attn"]["wq"]
    return out


def phase_train(dev, corpus, ckpt_dir, arch):
    """TrainLoop on ``arch`` at full width and full depth: the counters,
    set to 0 just before ``run()`` and read just after, must show the
    launches ``train_launches`` derives from the config; the loss stays
    finite, the gradient is nonzero and the watched parameters move."""
    cfg = train_config(arch)
    if not cfg.remat:
        raise AssertionError(f"{arch}: expected remat in its config")
    t0 = time.perf_counter()
    loop = TrainLoop(cfg, TrainLoopConfig(total_steps=TRAIN_STEPS,
                                          ckpt_every=TRAIN_STEPS + 1,
                                          ckpt_dir=ckpt_dir, log_every=1),
                     train_data(cfg, corpus, dev), seed=0, device=dev)
    n_par = sum(t.numel() for t in tree_leaves(loop.params))
    watch = watched(cfg, loop.params)
    before = {n: t.detach().clone() for n, t in watch.items()}
    cut = f" (of {get_config(arch).n_layers})" if arch in TRAIN_LAYERS \
        else ""
    log(f"train[{arch}]: {cfg.family} {cfg.n_layers}L{cut} d_model="
        f"{cfg.d_model} {describe(cfg)}vocab={cfg.vocab_size}: "
        f"{n_par / 1e9:.3f} B "
        f"params fp32, AdamW m/v fp32, remat={cfg.remat}, microbatches="
        f"{cfg.microbatches}, bf16 compute; batch {TRAIN_B} x {TRAIN_S} "
        f"tokens; built in {time.perf_counter() - t0:.1f} s")
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
        log(f"train[{arch}]: step {m['step']}: loss {m['loss']:.6f} "
            f"grad_norm {m['grad_norm']:.6f} lr {m['lr']:.3e}")
    log(f"train[{arch}]: {TRAIN_STEPS} steps in {run_s:.2f} s (first step "
        f"included); launches {launches}; peak memory {peak_gb:.2f} GB")
    want = train_launches(cfg, TRAIN_STEPS)
    if launches != want:
        raise AssertionError(f"train {arch}: launch counts {launches} != "
                             f"{want}")
    if len(loop.metrics_log) != TRAIN_STEPS or not all(
            np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
            for m in loop.metrics_log):
        raise AssertionError(f"train {arch}: non-finite metrics "
                             f"{loop.metrics_log}")
    if not all(m["grad_norm"] > 0 for m in loop.metrics_log):
        raise AssertionError(f"train {arch}: a zero gradient")
    moved = {n: float((watch[n].float() - before[n].float()).abs().max())
             for n in watch}
    if not all(v > 0 for v in moved.values()):
        raise AssertionError(f"train {arch}: parameters did not move: "
                             f"{moved}")
    log(f"train[{arch}]: largest change of watched parameters over the "
        f"run: { {n: f'{v:.3e}' for n, v in moved.items()} }")
    return cfg, loop, launches, peak_gb


def phase_train_times(dev, arch, cfg, loop, corpus):
    """The train step's device and host time after the run's warm-up,
    tokens/s, and where its time goes (torch.profiler over one step's
    forward + backward, then the optimizer by CUDA events)."""
    batch = card_batch(cfg, corpus, dev)
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
    log(f"train[{arch}]: step {step_ms:.3f} ms by CUDA events "
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
    log(f"where the time goes [train {arch}] (torch.profiler, one step):")
    wall, kern, host = _profile(fwd_bwd)
    _report("forward + backward", wall, kern, host)
    # the optimizer's few launches by CUDA events: a profiler window
    # opened right after the forward's and backward's tens of thousands of
    # kernels came back without them (mamba2, zamba2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e0.record()
    optimizer()
    e1.record()
    torch.cuda.synchronize()
    wall_o = (time.perf_counter() - t0) * 1e3
    busy_o = e0.elapsed_time(e1)
    log(f"  optimizer (AdamW): wall {wall_o:.3f} ms, {busy_o:.3f} ms by "
        f"CUDA events")
    busy = sum(us for us, _ in kern.values()) / 1e3
    share = 100 * (busy + busy_o) / (wall + wall_o)
    log(f"  train step: wall {wall + wall_o:.3f} ms, device busy "
        f"{busy + busy_o:.3f} ms ({share:.1f}%), optimizer {busy_o:.3f} ms "
        f"of it")
    del box
    peak_holders(arch, loop, batch)
    return {"step_ms": step_ms, "step_host_ms": host_ms,
            "tokens_per_s": tok_s, "profiled_busy_share": share / 100}


def _tensor_bytes(tree):
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def peak_holders(arch, loop, batch, top=10):
    """What holds the card's memory at the peak of one train step: the
    bytes allocated before it (parameters, AdamW's moments) and, from the
    caching allocator's history over the step, the blocks allocated in it
    that are live at its peak, grouped by the innermost line of
    ``repro_torch`` that allocated them."""
    from torch.cuda import memory as cmem
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cmem._record_memory_history(max_entries=2_000_000, stacks="python")
    try:
        loop.params, loop.opt_state, _ = loop.step_fn(loop.params,
                                                      loop.opt_state, batch)
        torch.cuda.synchronize()
        trace = cmem._snapshot()["device_traces"][torch.cuda.current_device()]
    finally:
        cmem._record_memory_history(enabled=None)
    peak_stat = torch.cuda.max_memory_allocated()

    def replay(upto):
        live, cur, peak, at = {}, base, base, -1
        for i, ev in enumerate(trace[:upto]):
            if ev["action"] == "alloc":
                live[ev["addr"]] = ev
                cur += ev["size"]
            elif ev["action"] == "free_completed" and ev["addr"] in live:
                cur -= live.pop(ev["addr"])["size"]
            if cur > peak:
                peak, at = cur, i
        return live, peak, at
    _, peak, at = replay(len(trace))
    live = replay(at + 1)[0]
    groups = {}
    for ev in live.values():
        frames = ev.get("frames", [])
        where = next((f"{f['filename'].split('/src/')[-1]}:{f['line']} "
                      f"{f['name']}" for f in frames
                      if "repro_torch" in f["filename"]),
                     "(no repro_torch frame: "
                     + (f"{frames[0]['filename']}:{frames[0]['line']})"
                        if frames else "no Python frame, e.g. the "
                        "backward's own thread)"))
        n, b = groups.get(where, (0, 0))
        groups[where] = (n + 1, b + ev["size"])
    par, opt = _tensor_bytes(loop.params), _tensor_bytes(loop.opt_state)
    log(f"memory at the peak of one train step [{arch}] (allocator history, "
        f"{len(trace)} events): {peak / 1e9:.3f} GB replayed "
        f"({peak_stat / 1e9:.3f} GB max_memory_allocated); before the step "
        f"{base / 1e9:.3f} GB: parameters {par / 1e9:.3f}, AdamW m/v "
        f"{opt / 1e9:.3f}, other {(base - par - opt) / 1e9:.3f}; allocated "
        f"in the step and live at its peak {(peak - base) / 1e9:.3f} GB in "
        f"{len(live)} blocks; largest holders:")
    for where, (n, b) in sorted(groups.items(), key=lambda kv: -kv[1][1])[
            :top]:
        log(f"    {b / 1e9:8.3f} GB  x{n:<5d} {where[:100]}")


def _plain_flash(q, k, v, *, causal=True, window=0, q_chunk=512, k_chunk=0,
                 scale=None, schedule="triangular", mesh=None, rules=None):
    if mesh is not None:
        raise ValueError("the plain attention stands in off the mesh only")
    return attn.reference_attention(q, k, v, causal=causal, window=window,
                                    scale=scale)


def _plain_ssd(x, dt, A_log, B_, C_, D_, *, chunk=256, state=None):
    return ssd_ref(x, dt, A_log, B_, C_, D_, chunk, state=state)


def phase_train_grads(dev, corpus, arch):
    """One step's loss and every gradient leaf at full width and one group
    of layers, through the kernels, against the same step with attention
    through autograd of the plain ``reference_attention``, the SSD
    through autograd of the plain chunked SSD (bf16 compute both) and the
    MoE slot positions by the one-hot cumsum. In the moe family the plain
    step routes every token as the kernel step did
    (``MoERoutes``; its own routes may differ only by near-ties): a route
    that a bf16 rounding flips moves a whole token to other experts, which
    says nothing of the kernels."""
    full = train_config(arch)
    cfg = full.replace(n_layers=full.attn_every if full.family == "hybrid"
                       else GRAD_LAYERS.get(arch, 2))
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(1),
                            device=dev)
    batch = card_batch(cfg, corpus, dev)
    for fn in KERNELS.values():
        fn.launches = 0
    with MoERoutes() as kernel_routes:
        loss_k, grads_k = loss_and_grads(cfg, params, batch)
        torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in KERNELS.items()}
    kernels = attn.flash_attention, ssd_ops.ssd, moe_mod.moe_slots
    attn.flash_attention, ssd_ops.ssd, moe_mod.moe_slots = \
        _plain_flash, _plain_ssd, moe_slots_ref
    try:
        with MoERoutes(force=lambda i, probs, ids:
                       kernel_routes.calls[i][1]) as plain_routes:
            loss_p, grads_p = loss_and_grads(cfg, params, batch)
            torch.cuda.synchronize()
    finally:
        attn.flash_attention, ssd_ops.ssd, moe_mod.moe_slots = kernels
    gap_tol = FLIP_GAPS[cfg.compute_dtype]
    flips = route_flips(plain_routes.calls,
                        [ids.reshape(-1, ids.shape[-1])
                         for _, ids in kernel_routes.calls],
                        cfg.moe.top_k if cfg.moe else 0,
                        lambda t: t.reshape(-1, t.shape[-1]), gap_tol)
    n_routed = sum(ids[..., 0].numel() for _, ids in kernel_routes.calls)
    routed = "" if cfg.moe is None else (
        f"; the plain step took the kernel step's routes in "
        f"{len(kernel_routes.calls)} router calls, its own differing in "
        f"{len(flips)} of {n_routed} tokens, all near-ties (largest "
        f"relative gap {max((g for _, _, g in flips), default=0.0):.1e} <= "
        f"{gap_tol:.1e})")
    want = train_launches(cfg, 1, optimizer=False)
    if launches != want:
        raise AssertionError(f"{arch} {cfg.n_layers}-layer step launches "
                             f"{launches} != {want}")
    if any(fn.launches != launches[n] for n, fn in KERNELS.items()):
        raise AssertionError("the plain step launched a kernel")
    loss_err = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    if not loss_err <= GRAD_LOSS_RTOL:
        raise AssertionError(f"{arch} {cfg.n_layers}-layer loss "
                             f"{float(loss_k)} vs plain {float(loss_p)}: "
                             f"{loss_err:.3e}")
    worst = ("", 0.0)
    names = [n for n, _ in _named_leaves(grads_k)]
    for name, a, b in zip(names, tree_leaves(grads_k), tree_leaves(grads_p)):
        if not b.any() and not a.any():  # vlm's embedding: not read
            continue
        rel = float((a.float() - b.float()).norm() / b.float().norm())
        if not (np.isfinite(rel) and rel <= GRAD_REL_L2):
            raise AssertionError(f"{arch} {cfg.n_layers}-layer gradient "
                                 f"{name}: relative L2 {rel:.3e} > "
                                 f"{GRAD_REL_L2}")
        worst = max(worst, (name, rel), key=lambda x: x[1])
    log(f"train[{arch}, {cfg.n_layers} layers]: kernels vs autograd of the "
        f"plain attention and SSD, one step at {TRAIN_B} x {TRAIN_S} "
        f"(launches {launches}): loss {float(loss_k):.6f} vs "
        f"{float(loss_p):.6f} (rel {loss_err:.2e}, tol {GRAD_LOSS_RTOL}); "
        f"{len(names)} gradient leaves, worst relative L2 {worst[1]:.3e} at "
        f"{worst[0]} (tol {GRAD_REL_L2}){routed}")
    return worst[1]


def _named_leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _named_leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def phase_train_restart(dev, ckpt_dir, arch):
    """Twin of test_substrate.py::test_train_restart_matches_uninterrupted
    on the card at smoke size (head_dim 32, which the flash kernels take):
    crash at step 8, restart from the port's ring checkpoint of step 5,
    and the final parameters are bitwise those of the uninterrupted run."""
    cfg = get_smoke_config(arch).replace(head_dim=32)
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
    log(f"train restart [{arch} smoke, hd 32]: crash at step "
        f"{RESTART_CRASH}, restart from the ring checkpoint of step {st}: "
        f"all {len(tree_leaves(p))} parameter leaves bitwise equal to the "
        f"uninterrupted {RESTART_STEPS} steps under "
        f"use_deterministic_algorithms; ops without a deterministic CUDA "
        f"version on the path: {nondet or 'none'}")


# ---------------------------------------------------------------------------
# phase 3: the mesh path on a 1 x 1 ("data", "model") mesh
# ---------------------------------------------------------------------------

# the mesh phase: each model's mesh run and its mesh=None twin, from one
# seed, one after the other (stablelm's two training states are 26.3 GB
# each: 1.644 B parameters x 16 B); deepseek-v2-lite-16b at its dense
# layer and one MoE layer (1.085 B parameters, 17.4 GB of state), through
# the explicit all-to-all (G = 16 at 4096 tokens a row)
MESH_TRAIN_STEPS = 3
MESH_TRAIN_LAYERS = {"deepseek-v2-lite-16b": 2}
# one rank runs the same kernels on the same bytes as mesh=None: held to
# 1e-5 relative (losses; the watched leaves' L2), and the bits reported
MESH_RTOL = 1e-5


def mesh_train_config(arch):
    cfg = train_config(arch)
    if arch in MESH_TRAIN_LAYERS:
        cfg = cfg.replace(n_layers=MESH_TRAIN_LAYERS[arch],
                          moe_impl="shard_map")
    return cfg


class StepTimer:
    """Wraps a loop's step function: the host time of each step, ended by a
    synchronize (the first step included, its warm-up)."""

    def __init__(self, loop):
        self.fn, self.ms = loop.step_fn, []
        loop.step_fn = self

    def __call__(self, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*args)
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def steady_ms(self):
        return float(np.mean(self.ms[1:]))


def mesh_train_run(dev, corpus, arch, mesh, ckpt_dir=None, routes=None):
    """A TrainLoop of MESH_TRAIN_STEPS steps on ``mesh`` (or without one)
    from seed 0 and the ring's batches, under ``routes`` (a MoERoutes) if
    given: (losses, watched leaves on the host, ms a step after the
    first, launches, loop)."""
    cfg = mesh_train_config(arch)
    rules = part.rules_for(mesh, TRAIN_B) if mesh is not None else None
    loop = TrainLoop(cfg, TrainLoopConfig(
        total_steps=MESH_TRAIN_STEPS, log_every=1,
        ckpt_every=MESH_TRAIN_STEPS - 1 if ckpt_dir else 10 ** 9,
        ckpt_dir=ckpt_dir or tempfile.gettempdir()),
        train_data(cfg, corpus, dev), mesh=mesh, rules=rules, seed=0,
        device=dev)
    timer = StepTimer(loop)
    torch.cuda.synchronize()
    for fn in KERNELS.values():
        fn.launches = 0
    with routes if routes is not None else contextlib.nullcontext():
        loop.run()
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in KERNELS.items()}
    want = train_launches(cfg, MESH_TRAIN_STEPS)
    if launches != want:
        raise AssertionError(f"mesh train {arch} (mesh {mesh is not None}): "
                             f"launches {launches} != {want}")
    losses = [m["loss"] for m in loop.metrics_log]
    if len(losses) != MESH_TRAIN_STEPS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"mesh train {arch}: losses {losses}")
    watch = {n: part.full(t).detach().float().cpu()
             for n, t in watched(cfg, loop.params).items()}
    return losses, watch, timer.steady_ms(), launches, loop


def compare_runs(what, a, b):
    """(largest relative loss error, largest watched-leaf relative L2,
    bit-identical) of two mesh_train_run results; over MESH_RTOL raises."""
    loss_err = max(abs(x - y) / abs(y) for x, y in zip(a[0], b[0]))
    l2 = max(float((a[1][n] - b[1][n]).norm() / b[1][n].norm())
             for n in b[1])
    same = a[0] == b[0] and all(torch.equal(a[1][n], b[1][n]) for n in b[1])
    if not (loss_err <= MESH_RTOL and l2 <= MESH_RTOL):
        raise AssertionError(f"{what}: mesh vs mesh=None losses {a[0]} vs "
                             f"{b[0]} (rel {loss_err:.3e}), watched leaves "
                             f"relative L2 {l2:.3e} > {MESH_RTOL}")
    return loss_err, l2, same


def mesh_stablelm(dev, corpus, mesh, ckpt_dir):
    """stablelm-1.6b at full width and depth: 3 TrainLoop steps on the mesh
    (parameters placed by param_specs), a ring checkpoint of the last
    step, ``restore(shardings=None)`` bitwise; then the mesh=None loop."""
    arch = "stablelm-1.6b"
    res = mesh_train_run(dev, corpus, arch, mesh, ckpt_dir=ckpt_dir)
    loop = res[4]
    t0 = time.perf_counter()
    saved = tree_leaves({"params": loop.params, "opt": loop.opt_state})
    step = loop.restore(shardings=None)
    restored = tree_leaves({"params": loop.params, "opt": loop.opt_state})
    if step != MESH_TRAIN_STEPS - 1 or len(restored) != len(saved):
        raise AssertionError(f"mesh restore: step {step}")
    differ = [i for i, (a, b) in enumerate(zip(saved, restored))
              if isinstance(b, part.DTensor)
              or not torch.equal(part.full(a), b)]
    if differ:
        raise AssertionError(f"mesh restore: leaves {differ} differ")
    ckpt_s = time.perf_counter() - t0
    n_bytes = sum(t.numel() * t.element_size() for t in restored)
    del saved, restored, loop
    res = res[:4]
    free_card()
    none = mesh_train_run(dev, corpus, arch, None)[:4]
    free_card()
    loss_err, l2, same = compare_runs(arch, res, none)
    log(f"mesh[{arch}]: {MESH_TRAIN_STEPS} steps on the 1 x 1 mesh: losses "
        f"{res[0]}; mesh=None {none[0]}: loss rel err {loss_err:.3e}, "
        f"watched leaves rel L2 {l2:.3e} (tol {MESH_RTOL}); bit-identical: "
        f"{same}; step {res[2]:.3f} ms (mesh) vs {none[2]:.3f} ms "
        f"(mesh=None), host clock after the first step; launches "
        f"{res[3]} each; ring checkpoint of step {step} ({n_bytes / 1e9:.2f} "
        f"GB) saved on the mesh and restore(shardings=None) bitwise in "
        f"{ckpt_s:.1f} s")
    return res[3], {"losses": res[0], "losses_mesh_none": none[0],
                    "loss_rel_err": loss_err, "watched_rel_l2": l2,
                    "bit_identical": same, "step_ms": res[2],
                    "step_ms_mesh_none": none[2],
                    "launches_mesh_none": none[3],
                    "restore_bitwise_gb": n_bytes / 1e9}


def mesh_deepseek(dev, corpus, mesh):
    """deepseek-v2-lite-16b, 1 dense + 1 MoE layer, moe_impl="shard_map"
    (the dispatch and combine through all_to_all_single): 3 steps on the
    mesh, then mesh=None (the constraint-free gshard path) taking the mesh
    run's routes, its own differing only by near-ties (FLIP_GAPS)."""
    from repro_torch.distributed import a2a as a2a_mod
    arch = "deepseek-v2-lite-16b"
    calls, inner = [0], a2a_mod._a2a

    def counted(*a, **k):
        calls[0] += 1
        return inner(*a, **k)
    a2a_mod._a2a = counted
    mesh_routes = MoERoutes()
    try:
        res = mesh_train_run(dev, corpus, arch, mesh, routes=mesh_routes)[:4]
    finally:
        a2a_mod._a2a = inner
    free_card()
    cfg = mesh_train_config(arch)
    n_moe = cfg.n_layers - cfg.moe.first_k_dense
    # a MoE layer: dispatch and combine forward, again in the remat
    # recompute, and both backward
    want_a2a = 6 * n_moe * MESH_TRAIN_STEPS
    if calls[0] != want_a2a:
        raise AssertionError(f"mesh {arch}: {calls[0]} all-to-alls, "
                             f"expected {want_a2a}")
    forced = MoERoutes(force=lambda i, probs, ids: mesh_routes.calls[i][1])
    none = mesh_train_run(dev, corpus, arch, None, routes=forced)[:4]
    free_card()
    gap_tol = FLIP_GAPS[cfg.compute_dtype]
    flips = route_flips(forced.calls,
                        [ids.reshape(-1, ids.shape[-1])
                         for _, ids in mesh_routes.calls],
                        cfg.moe.top_k, lambda t: t.reshape(-1, t.shape[-1]),
                        gap_tol)
    loss_err, l2, same = compare_runs(arch, res, none)
    log(f"mesh[{arch}]: {cfg.n_layers} layers, moe_impl=shard_map, "
        f"{MESH_TRAIN_STEPS} steps on the 1 x 1 mesh ({calls[0]} "
        f"all_to_all_single calls through NCCL): losses {res[0]}; mesh=None "
        f"{none[0]}: loss rel err {loss_err:.3e}, watched leaves rel L2 "
        f"{l2:.3e} (tol {MESH_RTOL}); bit-identical: {same}; route flips "
        f"{len(flips)} (near-ties <= {gap_tol:.1e}); step {res[2]:.3f} ms "
        f"(mesh) vs {none[2]:.3f} ms (mesh=None); launches {res[3]} each")
    return res[3], {"losses": res[0], "losses_mesh_none": none[0],
                    "loss_rel_err": loss_err, "watched_rel_l2": l2,
                    "bit_identical": same, "route_flips": len(flips),
                    "all_to_all_calls": calls[0], "step_ms": res[2],
                    "step_ms_mesh_none": none[2],
                    "launches_mesh_none": none[3]}


def mesh_zamba2(dev, mesh):
    """zamba2-2.7b's prefill at the serving shape (4 prompts of 512 from
    the numpy seed) by make_prefill_step on the mesh (the SSD kernel on
    each rank's block) against mesh=None: logits and every cache leaf
    within the hybrid tolerance."""
    arch = "zamba2-2.7b"
    cfg = serve_config(arch)
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0),
                            device=dev)
    rules = part.rules_for(mesh, BATCH)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)).to(dev)
    out = {}
    for name, m in (("mesh", mesh), ("none", None)):
        p = lm.place_params(cfg, params, m, rules) if m is not None \
            else params
        step = make_prefill_step(cfg, m, rules)
        with torch.no_grad():
            step(p, {"tokens": tokens})                 # warm-up
            torch.cuda.synchronize()
            for fn in KERNELS.values():
                fn.launches = 0
            t0 = time.perf_counter()
            logits, cache = step(p, {"tokens": tokens})
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        launches = {n: fn.launches for n, fn in KERNELS.items()}
        out[name] = (part.full(logits), {k: part.full(t)
                                         for k, t in cache.items()},
                     ms, launches)
        del p
    del params
    want = {n: 0 for n in KERNELS}
    want.update(flash_attention_fwd=cfg.n_layers // cfg.attn_every,
                ssd_chunk_call=cfg.n_layers)
    if out["mesh"][3] != want or out["none"][3] != want:
        raise AssertionError(f"mesh {arch} prefill launches "
                             f"{out['mesh'][3]} / {out['none'][3]} != {want}")
    atol, rtol = LOGIT_TOLS[cfg.family]
    errs = {"logits": check_close(f"mesh {arch} logits", out["mesh"][0],
                                  out["none"][0], atol, rtol)}
    for k in out["none"][1]:
        errs[k] = check_close(f"mesh {arch} cache {k}", out["mesh"][1][k],
                              out["none"][1][k], atol, rtol)
    same = torch.equal(out["mesh"][0], out["none"][0]) and all(
        torch.equal(out["mesh"][1][k], out["none"][1][k])
        for k in out["none"][1])
    log(f"mesh[{arch}]: prefill {BATCH}x{PROMPT} on the 1 x 1 mesh vs "
        f"mesh=None: max abs err {errs} (atol {atol} rtol {rtol}); "
        f"bit-identical: {same}; {out['mesh'][2]:.3f} ms (mesh) vs "
        f"{out['none'][2]:.3f} ms (mesh=None), host clock, one call after a "
        f"warm-up; launches {out['mesh'][3]} each")
    result = {"max_abs_err": errs, "bit_identical": same,
              "prefill_ms": out["mesh"][2],
              "prefill_ms_mesh_none": out["none"][2],
              "launches_mesh_none": out["none"][3]}
    launches = out["mesh"][3]
    del out
    free_card()
    return launches, result


# decode on the 1 x 1 mesh (PR 23): 8 steps after a mesh=None prefill of
# the serving prompts; deepseek-v2-lite at 2 layers, shard_map
MESH_DECODE = ("stablelm-1.6b", "zamba2-2.7b", "deepseek-v2-lite-16b")
MESH_DECODE_STEPS = 8


def mesh_decode(dev, mesh, arch):
    """``lm.decode_step(mesh=, rules=)`` on the 1 x 1 mesh (the cache placed
    by cache_specs, attention through the paged kernel with lse on the
    rank's shard and the fp32 merge; MLA on DTensors) against mesh=None
    from the same prefill cache: logits and greedy tokens bit for bit over
    MESH_DECODE_STEPS steps, and the same paged and SSD launches."""
    cfg = serve_config(arch)
    if arch in MESH_TRAIN_LAYERS:
        cfg = cfg.replace(n_layers=MESH_TRAIN_LAYERS[arch],
                          moe_impl="shard_map")
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0),
                            device=dev)
    params = lm.cast_params(cfg, params, torch.bfloat16)
    rules = part.rules_for(mesh, BATCH)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)).to(dev)
    with torch.no_grad():
        logits0, cache = make_prefill_step(cfg)(params, {"tokens": tokens})
        cache = lm.grow_cache(cfg, cache, MAX_LEN)
    tok0 = logits0[..., :cfg.vocab_size].argmax(-1).to(torch.int32)[:, None]
    defs = lm.cache_spec_defs(cfg, MAX_LEN, BATCH)
    out = {}
    for name, m in (("mesh", mesh), ("none", None)):
        c = {n: t.clone() for n, t in cache.items()}
        p = params
        if m is not None:
            p = lm.place_params(cfg, params, m, rules)
            c = {n: part.place(t, part.sharding_for(defs[n].logical, m,
                                                    rules))
                 for n, t in c.items()}
        torch.cuda.synchronize()
        for fn in KERNELS.values():
            fn.launches = 0
        logits, toks, t = [], [], tok0
        t0 = time.perf_counter()
        with torch.no_grad():
            for i in range(MESH_DECODE_STEPS):
                lg, c = lm.decode_step(cfg, p, c, t, PROMPT + i, mesh=m,
                                       rules=rules if m is not None
                                       else None)
                lg = part.full(lg)
                t = lg[..., :cfg.vocab_size].argmax(-1).to(
                    torch.int32)[:, None]
                logits.append(lg)
                toks.append(t)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / MESH_DECODE_STEPS
        out[name] = (torch.stack(logits), torch.cat(toks, 1),
                     {n: fn.launches for n, fn in KERNELS.items()}, ms)
        del c, p
    same = torch.equal(out["mesh"][0], out["none"][0]) and \
        torch.equal(out["mesh"][1], out["none"][1])
    err = float((out["mesh"][0].float() - out["none"][0].float())
                .abs().max())
    if not same or out["mesh"][2] != out["none"][2]:
        raise AssertionError(f"mesh decode {arch}: logits max abs err "
                             f"{err:.3e}, tokens equal "
                             f"{torch.equal(out['mesh'][1], out['none'][1])}"
                             f", launches {out['mesh'][2]} vs "
                             f"{out['none'][2]}")
    launches = out["mesh"][2]
    log(f"mesh[{arch}] decode: {MESH_DECODE_STEPS} steps on the 1 x 1 mesh "
        f"after a {BATCH}x{PROMPT} prefill: logits and tokens bit-identical "
        f"to mesh=None; {out['mesh'][3]:.3f} ms a step (mesh) vs "
        f"{out['none'][3]:.3f} ms (mesh=None), host clock; launches "
        f"{launches} each")
    result = {"bit_identical": same, "step_ms": out["mesh"][3],
              "step_ms_mesh_none": out["none"][3]}
    del out, params, cache
    free_card()
    return launches, result


def phase_mesh(dev, tmp):
    """The mesh path on the card: a 1 x 1 ("data", "model") mesh
    (``make_local_mesh``) over a one-rank NCCL group (a FileStore: no
    network); stablelm-1.6b and deepseek-v2-lite-16b train (on the ring
    corpora the training phase wrote into ``tmp``) and zamba2-2.7b
    prefills on it, each against its mesh=None twin. Returns (launches by
    path, results)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp, "mesh_store"), 1), rank=0, world_size=1,
        device_id=torch.device("cuda", 0))
    try:
        mesh = make_local_mesh()
        log(f"mesh: {mesh} over a one-rank NCCL group")
        launches, results = {}, {}
        corpus = {a: os.path.join(tmp, f"{a}.bin") for a in TRAIN_ARCHS}
        for arch, fn in (
                ("stablelm-1.6b", lambda: mesh_stablelm(
                    dev, corpus["stablelm-1.6b"], mesh,
                    os.path.join(tmp, "ckpt_mesh"))),
                ("deepseek-v2-lite-16b", lambda: mesh_deepseek(
                    dev, corpus["deepseek-v2-lite-16b"], mesh)),
                ("zamba2-2.7b", lambda: mesh_zamba2(dev, mesh))):
            kind = "prefill" if arch == "zamba2-2.7b" else "train"
            launches[f"mesh {kind} {arch}"], results[arch] = fn()
            free_card()
        for arch in MESH_DECODE:
            launches[f"mesh decode {arch}"], \
                results[f"decode {arch}"] = mesh_decode(dev, mesh, arch)
    finally:
        dist.destroy_process_group()
    return launches, results


# ---------------------------------------------------------------------------
# phase 3: the KV pager over a serving run's cache
# ---------------------------------------------------------------------------

def phase_pager(dev, arch, cfg, serve, prompts):
    """A serving run's real bf16 cache (prefill, then every decode step:
    543 positions of 544) cut into pages of 16 tokens and put into a
    KVPager, key (layer * B + sequence, block), whose frames hold one
    layer's pages and PAGER_SLACK more and whose host tier holds a quarter
    of the rest, so that pages spill to both tiers. Then, layer by layer:
    refault and pin the layer's pages in a seeded random order (as the
    sequences of a batch would touch them; in key order the pool can hand
    out frames in key order, and the table would be the identity), build
    the page table from
    ``slot_of``, upload the frames with ``device_pools()`` and run the
    paged kernel at the serving q shape through that table: bit-identical
    to the kernel over the dense cache through the identity table (what
    decode reads), and within tolerance of the plain version. Returns the
    kernel launches over the pager's pools (the dense reads compared with
    them are not counted)."""
    kinds = {n: 0 for n in KERNELS}
    with torch.inference_mode():
        tokens = torch.from_numpy(prompts).to(dev)
        logits0, cache = serve.prefill(serve.params, {"tokens": tokens})
        full = lm.grow_cache(cfg, cache, MAX_LEN)
        del cache
        nxt = logits0[..., :cfg.vocab_size].argmax(-1).to(torch.int32)[:, None]
        for pos in range(PROMPT, MAX_LEN - 1):
            nxt, full = serve.step(serve.params, full, nxt, pos)
        k_all, v_all = full["k"], full["v"]              # (L, B, Smax, KH, hd)
        del full
    L, B, Smax, KH, hd = k_all.shape
    P, H = lm.PAGE_SIZE, cfg.n_heads
    nblk, length = Smax // P, MAX_LEN - 1
    total = L * B * nblk
    n_frames = B * nblk + PAGER_SLACK
    pcfg = PagerConfig(n_hbm_pages=n_frames, page_tokens=P, kv_heads=KH,
                       head_dim=hd,
                       host_pages=int(PAGER_HOST_SHARE * (total - n_frames)),
                       nvme_pages=total)
    pager = KVPager(pcfg)
    k_cpu = k_all.view(L, B, nblk, P, KH, hd).cpu()
    v_cpu = v_all.view(L, B, nblk, P, KH, hd).cpu()
    t0 = time.perf_counter()
    for layer in range(L):
        for b in range(B):
            for j in range(nblk):
                pager.put_page_sync((layer * B + b, j), k_cpu[layer, b, j],
                                    v_cpu[layer, b, j])
    put_s = time.perf_counter() - t0
    del k_cpu, v_cpu
    rng = np.random.default_rng(5)
    q = rand(rng, (B, H, hd), torch.bfloat16, dev)     # the serving q shape
    ident, lens = lm.identity_pages(B, Smax, length - 1, 0, dev)
    pools_ms, worst, refault_s = [], 0.0, 0.0
    for layer in range(L):
        keys = [(layer * B + b, j) for b in range(B) for j in range(nblk)]
        t0 = time.perf_counter()
        pinned = [pager.fix_page_sync(keys[i])
                  for i in rng.permutation(len(keys))]
        refault_s += time.perf_counter() - t0
        table = torch.tensor([[pager.slot_of((layer * B + b, j))
                               for j in range(nblk)] for b in range(B)],
                             dtype=torch.int32).to(dev)
        if torch.equal(table, ident):
            raise AssertionError(f"pager {arch} layer {layer}: the table is "
                                 f"the identity")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        k_pool, v_pool = pager.device_pools(dev)
        torch.cuda.synchronize()
        pools_ms.append((time.perf_counter() - t0) * 1e3)
        before = {n: fn.launches for n, fn in KERNELS.items()}
        out = paged_kernel.paged_attention(q, k_pool, v_pool, table, lens)
        for n, fn in KERNELS.items():
            kinds[n] += fn.launches - before[n]
        dense = paged_kernel.paged_attention(
            q, k_all[layer].view(B * nblk, P, KH, hd),
            v_all[layer].view(B * nblk, P, KH, hd), ident, lens)
        if not torch.equal(out, dense):
            raise AssertionError(f"pager {arch} layer {layer}: the kernel "
                                 f"over the pager's pools differs from the "
                                 f"dense read")
        tol = TOLS[torch.bfloat16]
        worst = max(worst, check_close(
            f"pager {arch} layer {layer} vs plain", out,
            paged_ops.paged_attention_ref(q, k_pool, v_pool, table, lens),
            tol, tol))
        for idx in pinned:
            pager.pool.unfix(idx)
        del k_pool, v_pool
    torch.cuda.synchronize()
    counters = {"writebacks": pager.pool.writebacks,
                "host_reads": pager.host_reads,
                "cold_reads": pager.cold_reads}
    if not all(v > 0 for v in counters.values()):
        raise AssertionError(f"pager {arch}: a spill tier was not used: "
                             f"{counters}")
    if kinds["paged_attention"] != L:
        raise AssertionError(f"pager {arch}: {kinds} launches, not {L}")
    log(f"pager[{arch}]: {total} pages of {P} tokens ({pager.page_bytes} B: "
        f"{L} layers x {B} sequences x {nblk} blocks, KH={KH} hd={hd}) put "
        f"in {put_s:.2f} s (host); {n_frames} frames, host tier "
        f"{pcfg.host_pages} pages, cold tier the rest; per layer the table "
        f"from slot_of (not the identity), device_pools() + upload "
        f"{np.mean(pools_ms):.3f} ms mean (host, {min(pools_ms):.3f} - "
        f"{max(pools_ms):.3f}; {n_frames * pager.page_bytes / 1e6:.1f} MB), "
        f"refault + pin {refault_s / L * 1e3:.1f} ms a layer (host); the "
        f"kernel at q {tuple(q.shape)}, length {length}, over the pager's "
        f"pools: bit-identical to the dense read in all {L} layers, vs plain "
        f"max abs err {worst:.3e}; launches {kinds['paged_attention']}")
    log(f"pager[{arch}]: SIMULATED (the pager's virtual clock, not the "
        f"card): writebacks {pager.pool.writebacks}, host reads "
        f"{pager.host_reads}, cold reads {pager.cold_reads}, faults "
        f"{pager.pool.faults}, hits {pager.pool.hits}, evictions "
        f"{pager.pool.evictions}, spilled pages {pager.spilled_pages()}, "
        f"virtual time {pager.tl.now:.6f} s")
    del k_all, v_all, pager
    return kinds, {"device_pools_ms": float(np.mean(pools_ms)),
                   "max_abs_err": worst}


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------

def time_flash(rng, dev, H, KH, hd, B=BATCH, S=PROMPT, with_lse=False,
               hdv=None, window=0):
    """Device ms of the bf16 kernel (writing lse, as training calls it,
    with ``with_lse``), its plain version, SDPA and the bound; v's head dim
    is ``hdv`` (default ``hd``). A ``window`` must be no shorter than S,
    so that SDPA's causal mask and the bound hold. Where SDPA takes no
    call of these shapes, its time is None and the error is logged."""
    if window and window < S:
        raise ValueError(f"window {window} < S {S}: SDPA's causal mask "
                         f"would not be the same function")
    dt = torch.bfloat16
    hdv = hdv or hd
    sets = [tuple(rand(rng, (B, S, n, d), dt, dev)
                  for n, d in ((H, hd), (KH, hd), (KH, hdv)))
            for _ in range(4)]                       # 4 x >= 33.5 MB > L2
    reps = max(5, 50 * PROMPT * PROMPT // (S * S))
    scale = hd ** -0.5
    ms = cuda_ms(lambda i: flash_kernel.flash_attention_fwd(
        *sets[i], scale=scale, with_lse=with_lse, window=window), 4, reps)
    plain_ms = cuda_ms(lambda i: attn.reference_attention(
        *sets[i], scale=scale, window=window), 4, max(3, reps // 5))
    t_sets = [tuple(t.transpose(1, 2).contiguous() for t in s) for s in sets]
    gqa = dict(enable_gqa=True) if KH != H else {}
    try:
        lib_ms, lib_note = cuda_ms(
            lambda i: F.scaled_dot_product_attention(
                *t_sets[i], is_causal=True, scale=scale, **gqa), 4, reps), ""
    except RuntimeError as exc:           # no backend takes the shapes
        lib_ms, lib_note = None, f" ({str(exc).splitlines()[0][:120]})"
    bnd = bound(*work.flash_fwd_work(B, S, S, H, KH, hd, hdv, 2,
                                     with_lse=with_lse, window=window), dt)
    dims = f"q/k {hd} v {hdv}" if hdv != hd else f"hd {hd}"
    lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
    log(f"  flash  q {(B, S, H)} {dims}, k/v {KH} heads bf16 causal"
        f"{f' window {window}' if window else ''}"
        f"{' (+lse)' if with_lse else ''}: kernel {ms:.4f} ms "
        f"({flash_kernel.plan(hd, hdv)}), plain {plain_ms:.4f} ms, sdpa "
        f"{lib}{lib_note}, bound {bnd[0]:.4f} ms ({bnd[1]})")
    return ms, plain_ms, lib_ms, bnd


def time_flash_bwd(rng, dev, B=TRAIN_B, S=TRAIN_S, H=32, hd=64, KH=None,
                   hdv=None):
    """Device ms of the backward kernel at the training shape (causal,
    bf16), its plain version, the backward of SDPA (causal) and the
    bound: q/o/do, k/v (KH heads) and lse read once, dq, dk/dv written
    once; five products over the causal pairs, S and dQ and dK over the
    q/k head dim ``hd``, dP and dV over v's ``hdv`` (default ``hd``)."""
    dt = torch.bfloat16
    KH = KH or H
    hdv = hdv or hd
    sets = []
    for _ in range(2):                               # 2 x >= 64 MB > L2
        q = rand(rng, (B, S, H, hd), dt, dev)
        do = rand(rng, (B, S, H, hdv), dt, dev)
        k = rand(rng, (B, S, KH, hd), dt, dev)
        v = rand(rng, (B, S, KH, hdv), dt, dev)
        o, lse = flash_kernel.flash_attention_fwd(q, k, v, with_lse=True)
        sets.append((q, k, v, o, lse, do))
    ms = cuda_ms(lambda i: flash_kernel.flash_attention_bwd(*sets[i]), 2, 5,
                 warmup=2)
    plain_ms = cuda_ms(lambda i: flash_attention_bwd_ref(*sets[i]), 2, 2,
                       warmup=1)
    lib = []
    gqa = dict(enable_gqa=True) if KH != H else {}
    try:
        for q, k, v, _, _, do in sets:
            qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                          for t in (q, k, v))
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                 **gqa)
            lib.append((out, (qt, kt, vt), do.transpose(1, 2).contiguous()))
        lib_ms, lib_note = cuda_ms(lambda i: torch.autograd.grad(
            lib[i][0], lib[i][1], lib[i][2], retain_graph=True), 2, 10), ""
    except RuntimeError as exc:           # no backend takes the shapes
        lib_ms, lib_note = None, f" ({str(exc).splitlines()[0][:120]})"
    n_bytes, flops = work.flash_bwd_work(B, S, S, H, KH, hd, hdv, 2)
    bnd = bound(n_bytes, flops, dt)
    dims = f"hd {hd}" if hdv == hd else f"q/k {hd} v {hdv}"
    log(f"  flash bwd q {(B, S, H)} {dims}, k/v {KH} heads bf16 causal: "
        f"kernel "
        f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s "
        f"of the five products; {flash_kernel.plan_bwd(hd, hdv)}), plain "
        f"{plain_ms:.4f} ms, backward of sdpa "
        f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}{lib_note}, "
        f"bound {bnd[0]:.4f} ms ({bnd[1]})")
    del lib
    return ms, plain_ms, lib_ms, bnd


def time_moe_slots(rng, dev):
    """Device ms of the MoE slot kernel alone at the cells' calls
    (``moe_slot_shapes``), beside the plain version (the one-hot cumsum
    the layer ran before) and the bound of its bytes: label -> (ms,
    plain_ms, None, bound); no one PyTorch call computes it."""
    out = {}
    for label, BG, N, Ee, C in moe_slot_shapes():
        eids = [torch.from_numpy(rng.integers(0, Ee, (BG, N))).to(dev)
                for _ in range(4)]
        ms = cuda_ms(lambda i: slots_kernel.moe_slots(eids[i], Ee, C), 4,
                     200)
        plain_ms = cuda_ms(lambda i: moe_slots_ref(eids[i], Ee, C), 4, 10)
        bnd = bound(*work.moe_slots_work(BG, N, Ee), torch.bfloat16)
        tiles = -(-N // slots_kernel.tile())
        log(f"  moe_slots {label}: BG {BG}, N {N}, Ee {Ee}, C {C} "
            f"({tiles} tile{'s' if tiles > 1 else ''} of "
            f"{slots_kernel.tile()} a group, {1 + (tiles > 1)} launch"
            f"{'es' if tiles > 1 else ''}): kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
        out[label] = (ms, plain_ms, None, bnd)
    return out


def time_paged(rng, dev, H, KH, hd, length, with_lse=False):
    """Device ms at one decode length (the split depends on the pages);
    with ``with_lse`` the kernel also writes each row's lse (the mesh
    decode's call), and the plain version returns it too."""
    dt = torch.bfloat16
    B = BATCH
    per_seq = MAX_LEN // lm.PAGE_SIZE
    table, lens = lm.identity_pages(B, MAX_LEN, length - 1, 0, dev)
    q = rand(rng, (B, H, hd), dt, dev)
    pools = [tuple(rand(rng, (B * per_seq, lm.PAGE_SIZE, KH, hd), dt, dev)
                   for _ in range(2)) for _ in range(8)]   # 8 x 17.8 MB
    ms = cuda_ms(lambda i: paged_kernel.paged_attention(
        q, *pools[i], table, lens, with_lse=with_lse), 8, 200)
    plain_ms = cuda_ms(lambda i: paged_ops.paged_attention_ref(
        q, *pools[i], table, lens, with_lse=with_lse), 8, 20)
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
    bnd = bound(*work.paged_work(B, H, KH, hd, length, table.shape[1], 2,
                                 with_lse=with_lse), dt)
    plan = paged_kernel.plan(table.shape[1], lm.PAGE_SIZE, H // KH, hd, dt)
    R = plan["row_tiles"]
    log(f"  paged{' +lse' if with_lse else ''}  q {(B, H, hd)} over "
        f"{table.shape[1]} pages x "
        f"{lm.PAGE_SIZE}, length {length}, {R} row tiles of "
        f"{plan['rows_per_tile']} query rows, clusters of {plan['n_split']} "
        f"CTAs x {plan['pages_per_split']} pages ({plan['pages_per_stage']} "
        f"a stage, {plan['smem_bytes']} B shared), grid "
        f"{plan['n_split'] * KH * R * B} CTAs, {KH * R * B} clusters of "
        f"which {plan['max_active_clusters']} fit at once: kernel {ms:.4f} "
        f"ms, plain "
        f"{plain_ms:.4f} ms, sdpa over the dense cache {lib_ms:.4f} ms, "
        f"bound {bnd[0]:.4f} ms ({bnd[1]})")
    return ms, plain_ms, lib_ms, bnd


def time_ssd(rng, dev, nh, hp, ns, S, cl, what, B=BATCH):
    dt = torch.bfloat16
    n_sets = 4
    sets = [ssd_inputs(rng, dev, B, S, nh, hp, ns, dt) for _ in range(n_sets)]
    reps = 50 if S > 1 else 500
    ms = cuda_ms(lambda i: ssd_kernel.ssd_chunk_call(*sets[i], chunk=cl),
                 n_sets, reps)
    plain_ms = cuda_ms(lambda i: ssd_chunk_ref(*sets[i], chunk=cl), n_sets,
                       max(5, reps // 10))
    byt, flops = work.ssd_work(B, S, nh, hp, ns, cl, 2)
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


def time_ssd_bwd(rng, dev, B, S, nh, hp, ns, cl, what):
    """Device ms of the backward kernel at a training call (bf16 x/B/C,
    fp32 cotangents), its plain version and its bound; no one PyTorch call
    computes this gradient."""
    dt = torch.bfloat16
    nc = S // cl
    sets = []
    for _ in range(2):                             # 2 x >= 195 MB > L2
        args = ssd_inputs(rng, dev, B, S, nh, hp, ns, dt)
        cots = [rand(rng, shape, torch.float32, dev) for shape in (
            (B, nc, cl, nh, hp), (B, nc, nh, hp, ns), (B, nc, cl, nh),
            (B, nc, nh))]
        sets.append(args + tuple(cots))
    ms = cuda_ms(lambda i: ssd_kernel.ssd_chunk_bwd(*sets[i], chunk=cl), 2,
                 10, warmup=2)
    plain_ms = cuda_ms(lambda i: ssd_chunk_bwd_ref(*sets[i], chunk=cl), 2,
                       3, warmup=1)
    byt, flops = work.ssd_bwd_work(B, S, nh, hp, ns, cl, 2)
    t_bytes, t_ops = byt / PEAK_BYTES_PER_S, flops / SSD_RATE[1]
    bnd = (max(t_bytes, t_ops) * 1e3,
           "bytes" if t_bytes >= t_ops else "operations")
    mma = work.ssd_bwd_mma_work(B, S, nh, hp, ns, cl)
    log(f"  ssd bwd {what}: x {(B, S, nh, hp)} ns {ns} cl {cl} bf16: kernel "
        f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s of its "
        f"{flops / 1e9:.2f} GFLOP; its split issues {mma / 1e9:.2f} GFLOP "
        f"of bf16 products, {mma / ms / 1e9:.1f} TFLOP/s), plain "
        f"{plain_ms:.4f} ms, library none, bound {bnd[0]:.4f} ms ({bnd[1]}; "
        f"{byt / 1e6:.1f} MB at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s, "
        f"{flops / 1e9:.3f} GFLOP at the {SSD_RATE[0]}' "
        f"{SSD_RATE[1] / 1e12:.0f} TFLOP/s)")
    plan = ssd_kernel.plan_bwd(B, S, nh, hp, ns, cl, dt)
    log(f"    launches (heads a CTA {plan['heads_per_cta']}, column splits "
        f"{plan['column_splits']}, {plan['sms']} SMs; "
        f"cudaFuncGetAttributes):")
    for name, k in plan["kernels"].items():
        log(f"      {name}: {k['ctas']} CTAs x {k['threads']}, "
            f"{k['smem_bytes']} B shared, {k['registers']} registers, "
            f"{k['spill_bytes']} B local (spills), {k['ctas_per_sm']} a SM")
    return ms, plain_ms, None, bnd


def time_adamw(dev):
    """Device ms of one AdamW step's two passes (the norm with its finish,
    then the update) at the training configuration of deepseek-v2-lite
    (``train_config``: 29 fp32 leaves, 2.84 B elements, the benchmark's
    ``dsv2lite-train-4k``), beside the plain version (the norm and the
    update the optimizer ran before the kernels), ``torch._fused_adamw_``
    over the same leaves as a yardstick (the port never calls it; it
    decays every leaf and neither clips nor reads a norm) and the bound of
    32 B an element: (ms, plain_ms, library_ms, bound), and each pass's
    ms."""
    shapes = adamw_train_shapes()
    gen = torch.Generator(dev).manual_seed(0)
    p, g, m = ([torch.randn(s, generator=gen, device=dev) for s in shapes]
               for _ in range(3))
    v = [x.square() for x in m]
    n = sum(x.numel() for x in p)
    t = torch.tensor(3.0, device=dev)
    lr, bc1, bc2 = (torch.tensor(3e-4, device=dev), 1 - torch.pow(0.9, t),
                    1 - torch.pow(0.95, t))
    scale = adamw_kernel.adamw_norm(adamw_kernel.adamw_sumsq(g), 1.0)[1]
    norm_ms = cuda_ms(lambda i: adamw_kernel.adamw_norm(
        adamw_kernel.adamw_sumsq(g), 1.0), 1, 20)
    update_ms = cuda_ms(lambda i: adamw_kernel.adamw_update_(
        p, g, m, v, scale, lr, bc1, bc2, **ADAMW_CONSTS), 1, 10)

    def plain(i):
        _, sc = adamw_norm_ref(adamw_sumsq_ref(g), 1.0)
        adamw_update_ref(p, g, m, v, sc, lr, bc1, bc2, **ADAMW_CONSTS)
    plain_ms = cuda_ms(plain, 1, 3, warmup=1)
    steps = [torch.tensor(3.0, device=dev) for _ in p]
    lib_ms = cuda_ms(lambda i: torch._fused_adamw_(
        p, g, m, v, [], steps, lr=3e-4, beta1=0.9, beta2=0.95,
        weight_decay=0.1, eps=1e-8, amsgrad=False, maximize=False), 1, 10)
    nbytes = work.adamw_sumsq_work(n)[0] + work.adamw_update_work(n)[0]
    bnd = bound(nbytes, 0, torch.float32)
    ms = norm_ms + update_ms
    log(f"  adamw at deepseek-v2-lite's training leaves ({len(p)} leaves, "
        f"{n} fp32 elements, {nbytes / 1e9:.1f} GB): norm {norm_ms:.3f} ms "
        f"+ update {update_ms:.3f} ms = {ms:.3f} ms ({100 * bnd[0] / ms:.1f}%"
        f" of the bound {bnd[0]:.3f} ms, {bnd[1]}; "
        f"{nbytes / ms / 1e6:.0f} GB/s), plain {plain_ms:.3f} ms, "
        f"torch._fused_adamw_ {lib_ms:.3f} ms; launches a step: sum of "
        f"squares {-(-len(p) // adamw_kernel.table_leaves())}, finish 1, "
        f"update {-(-len(p) // adamw_kernel.table_leaves())}")
    del p, g, m, v
    free_card()
    return (ms, plain_ms, lib_ms, bnd), {"norm_ms": norm_ms,
                                         "update_ms": update_ms}


def phase_kernel_times(dev):
    rng = np.random.default_rng(1)
    log("kernel times at the serving and training shapes (device ms a "
        "call: CUDA events over back-to-back calls queued behind a held "
        "stream):")
    out = {"moe_slots": time_moe_slots(rng, dev)}
    out["adamw"] = time_adamw(dev)
    out["flash_attention_fwd"] = time_flash(rng, dev, 32, 32, 64)
    time_flash(rng, dev, 32, 32, 80)                  # zamba2-2.7b
    out["flash_attention_fwd train"] = time_flash(
        rng, dev, 32, 32, 64, B=TRAIN_B, S=TRAIN_S, with_lse=True)
    free_card()
    out["flash_attention_bwd"] = time_flash_bwd(rng, dev)
    free_card()
    time_flash_bwd(rng, dev, hd=80)                   # zamba2-2.7b
    free_card()
    time_flash_bwd(rng, dev, H=16, hd=128)
    free_card()
    # qwen2-vl-2b: GQA 6:1 at hd 128, prefill, training forward and backward
    qwen = {"flash_attention_fwd": time_flash(rng, dev, 12, 2, 128)}
    qwen["flash_attention_fwd train"] = time_flash(
        rng, dev, 12, 2, 128, B=TRAIN_B, S=TRAIN_S, with_lse=True)
    free_card()
    qwen["flash_attention_bwd"] = time_flash_bwd(rng, dev, H=12, hd=128,
                                                 KH=2)
    free_card()
    # the first and last decode steps' lengths: 33 and 34 pages
    time_paged(rng, dev, 32, 32, 64, PROMPT + 1)
    out["paged_attention"] = time_paged(rng, dev, 32, 32, 64, MAX_LEN - 1)
    # with lse: the call of the mesh decode (a shard's partial softmax)
    out["paged_attention lse"] = time_paged(rng, dev, 32, 32, 64,
                                            MAX_LEN - 1, with_lse=True)
    time_paged(rng, dev, 32, 32, 80, PROMPT + 1)      # zamba2-2.7b
    time_paged(rng, dev, 32, 32, 80, MAX_LEN - 1)
    time_paged(rng, dev, 12, 2, 128, PROMPT + 1)      # qwen2-vl-2b: G = 6
    qwen["paged_attention"] = time_paged(rng, dev, 12, 2, 128, MAX_LEN - 1)
    qwen["paged_attention lse"] = time_paged(rng, dev, 12, 2, 128,
                                             MAX_LEN - 1, with_lse=True)
    # mixtral-8x22b's decode (G = 6 over 8 KV heads), its prefill and its
    # training call's forward (window 4096 >= S); deepseek-v2-lite's
    # prefill at q/k 192, v 128
    time_paged(rng, dev, 48, 8, 128, PROMPT + 1)
    mixtral = {"paged_attention": time_paged(rng, dev, 48, 8, 128,
                                             MAX_LEN - 1),
               "flash_attention_fwd": time_flash(rng, dev, 48, 8, 128,
                                                 window=4096)}
    mixtral["flash_attention_fwd train"] = time_flash(
        rng, dev, 48, 8, 128, B=TRAIN_B, S=TRAIN_S, with_lse=True,
        window=4096)
    mla = {"flash_attention_fwd": time_flash(rng, dev, 16, 16, 192,
                                             hdv=128)}
    free_card()
    mixtral["flash_attention_bwd"] = time_flash_bwd(rng, dev, H=48, hd=128,
                                                    KH=8)
    free_card()
    # deepseek-v2-lite's training call: the forward with lse and the
    # backward at q/k 192, v 128, 16 heads, 2 x 4096
    mla["flash_attention_fwd train"] = time_flash(
        rng, dev, 16, 16, 192, B=TRAIN_B, S=TRAIN_S, with_lse=True, hdv=128)
    free_card()
    mla["flash_attention_bwd"] = time_flash_bwd(rng, dev, H=16, hd=192,
                                                hdv=128)
    free_card()
    # the decode of granite-34b (48 query rows over one KV head: row
    # tiles), yi-34b (G 7) and deepseek-67b (G 8), at the last decode
    # length, and their prefill
    dense = {}
    for label, G, KH in DENSE_LARGE:
        dense[label] = {"paged_attention": time_paged(
            rng, dev, G * KH, KH, 128, MAX_LEN - 1),
            "flash_attention_fwd": time_flash(rng, dev, G * KH, KH, 128)}
    # granite-34b's row tiles with lse
    dense["granite_34b"]["paged_attention lse"] = time_paged(
        rng, dev, 48, 1, 128, MAX_LEN - 1, with_lse=True)
    free_card()
    out["ssd_chunk_call"] = time_ssd(rng, dev, 80, 64, 64, PROMPT, 256,
                                     "zamba2-2.7b prefill")
    time_ssd(rng, dev, 24, 64, 128, PROMPT, 256, "mamba2-130m prefill")
    time_ssd(rng, dev, 80, 64, 64, 1, 1, "zamba2-2.7b decode step")
    time_ssd(rng, dev, 24, 64, 128, 1, 1, "mamba2-130m decode step")
    free_card()
    # the training calls: one microbatch of zamba2-2.7b, mamba2-130m's batch
    time_ssd(rng, dev, 80, 64, 64, TRAIN_S, 256, "zamba2-2.7b train", B=1)
    time_ssd(rng, dev, 24, 64, 128, TRAIN_S, 256, "mamba2-130m train",
             B=TRAIN_B)
    out["ssd_chunk_bwd"] = time_ssd_bwd(rng, dev, 1, TRAIN_S, 80, 64, 64,
                                        256, "zamba2-2.7b train")
    free_card()
    time_ssd_bwd(rng, dev, TRAIN_B, TRAIN_S, 24, 64, 128, 256,
                 "mamba2-130m train")
    free_card()
    return out, {"qwen2_vl": qwen, "mixtral": mixtral, "deepseek_mla": mla,
                 **dense}


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
        nxt = logits0[..., :cfg.vocab_size].argmax(-1).to(torch.int32)[:, None]
        serve.step(serve.params, full, nxt, PROMPT)       # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        def decode():
            """ms a decode step by CUDA events and by the host clock."""
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t, t0 = nxt, time.perf_counter()
            e0.record()
            for pos in range(PROMPT, PROMPT + NEW - 1):
                t, _ = serve.step(serve.params, full, t, pos)
            e1.record()
            torch.cuda.synchronize()
            return (e0.elapsed_time(e1) / (NEW - 1),
                    (time.perf_counter() - t0) * 1e3 / (NEW - 1))
        decode_ms, host_ms = decode()
        walls = {}
        if arch in DISPATCH_ARCHS:
            # the kernel ops' dispatch: the same steps with the ops' entry
            # points calling the kernels' wrappers directly (as before they
            # were torch custom ops), in turns: ops, direct, direct, ops
            runs = {"ops": [(decode_ms, host_ms)], "direct": []}
            with direct_kernel_calls():
                runs["direct"] += [decode(), decode()]
            runs["ops"].append(decode())
            walls = {k: float(np.mean([h for _, h in v]))
                     for k, v in runs.items()}
            log(f"serve[{arch}]: decode wall through the custom ops "
                f"{walls['ops']:.3f} ms/step, calling the wrappers directly "
                f"{walls['direct']:.3f} ms/step (host clock, synchronized, "
                f"each the mean of 2 runs of {NEW - 1} steps, in turns; "
                f"device {np.mean([d for d, _ in runs['ops']]):.3f} / "
                f"{np.mean([d for d, _ in runs['direct']]):.3f} ms)")
        del full
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"serve[{arch}]: prefill {BATCH}x{PROMPT}: {prefill_ms:.3f} ms (host "
        f"clock, synchronized, mean of {reps}); decode: {decode_ms:.3f} "
        f"ms/step by CUDA events ({host_ms:.3f} ms host), "
        f"{BATCH * 1e3 / decode_ms:.1f} tokens/s at batch {BATCH}; peak "
        f"memory {peak_gb:.2f} GB")
    out = {"prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms}
    if walls:
        out.update(decode_wall_ms_ops=walls["ops"],
                   decode_wall_ms_direct=walls["direct"])
    return out


# the serving runs whose decode walls are taken with the kernel ops'
# dispatch and without it (phase 4)
DISPATCH_ARCHS = ("stablelm-1.6b", "zamba2-2.7b")


@contextlib.contextmanager
def direct_kernel_calls():
    """The kernel ops' entry points (``paged_attention``, ``FlashAttention``,
    ``SSDChunk``) call each op's implementation directly, as they called
    the kernels' wrappers before the ops were torch custom ops: the same
    launches without the dispatcher, to time what the dispatch costs."""
    swaps = [(paged_ops, "paged_op", paged_ops._route),
             (paged_ops, "paged_lse_op", paged_ops._route_lse),
             (flash_ops, "fwd_op", flash_ops._fwd),
             (flash_ops, "fwd_lse_op", flash_ops._fwd_lse),
             (flash_ops, "bwd_op", flash_ops._bwd),
             (ssd_ops, "chunk_op", ssd_ops._chunk),
             (ssd_ops, "chunk_bwd_op", ssd_ops._chunk_bwd)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


# ---------------------------------------------------------------------------
# phase 5: where the time goes (torch.profiler)
# ---------------------------------------------------------------------------

KINDS = (("flash fwd", ("flash_fwd_",)),
         ("flash bwd", ("flash_bwd_",)),
         ("paged kernel", ("paged_split_kernel",)),
         ("ssd bwd", ("ssd_bwd_",)),
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


MOE_STAGES = ("moe_router", "moe_dispatch", "moe_experts", "moe_combine",
              "moe_shared")


def _profile(fn):
    """Host wall ms of ``fn``, its device kernels (name -> (us, n)) and the
    host operators by self CPU time (name -> (us, n)); the MoE stages'
    ranges (``moe_ffn``'s ``record_function``s) appear among the host
    operators with the device time of the kernels they launched as a third
    number."""
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
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                e.name not in MOE_STAGES:        # not the ranges' GPU marks
            us, n = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    if not kernels:
        raise AssertionError("torch.profiler recorded no device kernels")
    host = {e.key: (e.self_cpu_time_total, e.count)
            + ((e.device_time_total,) if e.key in MOE_STAGES else ())
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
    bwd = sorted(((name, v) for name, v in kernels.items()
                  if "ssd_bwd_" in name), key=lambda kv: -kv[1][0])
    if bwd:
        log("    the SSD backward by kernel:")
        for name, (us, n) in bwd:
            log(f"    {us / 1e3 / steps:8.3f} ms  x{n // steps:<4d} "
                f"{name[:110]}")
    stages = {n: host[n][2] for n in MOE_STAGES if n in host}
    if stages:
        flash, paged = (by_kind.get(k, 0.0) / steps
                        for k in ("flash fwd", "paged kernel"))
        log("    the MoE layers by stage (device ms of the kernels each "
            "range launched): " + ", ".join(
                f"{n[4:]} {us / 1e3 / steps:.3f}" for n, us in stages.items())
            + f"; attention kernels: flash {flash:.3f}, paged {paged:.3f}")
    host_ms = sum(v[0] for v in host.values()) / 1e3
    log(f"    host operators, self CPU {host_ms / steps:.3f} ms; top:")
    for name, (us, n, *_) in sorted(host.items(),
                                    key=lambda kv: -kv[1][0])[:8]:
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
        nxt = logits0[..., :cfg.vocab_size].argmax(-1).to(torch.int32)[:, None]

        def decode():
            t = nxt
            for pos in range(PROMPT, PROMPT + steps):
                t, _ = serve.step(serve.params, full, t, pos)
        wall, kern, host = _profile(decode)
        _report(f"decode step (mean of {steps})", wall, kern, host, steps)


# ---------------------------------------------------------------------------
# the dry run (launch/dryrun.py) on the card machine's CUDA build
# ---------------------------------------------------------------------------

DRYRUN_CELLS = (("stablelm-1.6b", "train_4k"), ("stablelm-1.6b", "decode_32k"))
DRYRUN_TIMEOUT = 600
# phase 4's stablelm training step, traced on one device (a 1 x 1 mesh)
ONE_CARD_CELL = """
import json, sys
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch.dryrun import run_cell
r = run_cell("stablelm-1.6b", ShapeConfig("train_4k", {S}, {B}, "train"),
             False, sys.argv[1], tag="one_card", device="cuda",
             mesh_shape=((1, 1), ("data", "model")))
print(json.dumps({{"flops": r["flops_per_device"],
                  "bytes": r["bytes_per_device"],
                  "peak": r["memory"]["peak_est_bytes"],
                  "trace_s": r["trace_s"]}}))
"""


def phase_dryrun(train_ms, smi_line):
    """``launch/dryrun.py`` in subprocesses (a fake process group cannot
    share a process with the NCCL one), all started together, with fake
    CUDA tensors (no card memory): stablelm-1.6b's train_4k and decode_32k
    cells on the 16 x 16 mesh, and phase 4's stablelm training step (2 x
    4096, one device), whose FLOPs over the measured step give its
    TFLOP/s. Any failed trace raises."""
    tmp = tempfile.mkdtemp(prefix="dryrun_")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    try:
        procs = {cell: subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             cell[0], "--shape", cell[1], "--device", "cuda", "--out", tmp],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for cell in DRYRUN_CELLS}
        procs["one card"] = subprocess.Popen(
            [sys.executable, "-c", ONE_CARD_CELL.format(S=TRAIN_S, B=TRAIN_B),
             tmp], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        outs = {}
        for key, proc in procs.items():
            try:
                out, err = proc.communicate(timeout=DRYRUN_TIMEOUT)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            if proc.returncode != 0:
                raise AssertionError(f"dry run {key}: exit {proc.returncode}"
                                     f"\n{out[-2000:]}\n{err[-4000:]}")
            outs[key] = out
        results = {}
        for arch, shape in DRYRUN_CELLS:
            with open(os.path.join(tmp, f"{arch}_{shape}_16x16.json")) as f:
                r = json.load(f)
            kinds = {k: (v["count"], v["bytes"]) for k, v in
                     r["collectives"].items()}
            log(f"dryrun[{arch} {shape} 16x16, {r['mesh_device']}, torch "
                f"{r['torch']}]: {r['flops_per_device'] / 1e12:.3f} TFLOP, "
                f"{r['bytes_per_device'] / 1e9:.3f} GB moved, collectives "
                f"(count, bytes) {kinds}, peak "
                f"{r['memory']['peak_est_bytes'] / 1e9:.2f} GB a device, "
                f"t_bound {r['roofline']['t_bound_s']:.4f} s "
                f"({r['roofline']['bottleneck']}), trace {r['trace_s']} s; "
                f"CommDebugMode {r['comm_debug_counts']} (agrees: "
                f"{r['comm_debug_agrees']})")
            results[f"{arch} {shape}"] = {
                "flops": r["flops_per_device"],
                "bytes": r["bytes_per_device"],
                "peak_gb": r["memory"]["peak_est_bytes"] / 1e9,
                "t_bound_s": r["roofline"]["t_bound_s"],
                "trace_s": r["trace_s"]}
        one = json.loads(outs["one card"].strip().splitlines()[-1])
        tflops = one["flops"] / train_ms / 1e9
        log(f"dryrun[stablelm-1.6b train step, one device, {TRAIN_B} x "
            f"{TRAIN_S}]: {one['flops'] / 1e12:.3f} TFLOP traced over the "
            f"measured step of {train_ms:.3f} ms: {tflops:.1f} TFLOP/s, "
            f"{100 * tflops * 1e12 / PEAK_FLOPS[torch.bfloat16]:.1f}% of "
            f"989 TFLOP/s; card {smi_line}; traced peak "
            f"{one['peak'] / 1e9:.2f} GB, trace {one['trace_s']} s")
        results["one card train"] = dict(one, step_ms=train_ms,
                                         tflops_per_s=tflops)
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 7: the storage and network engines (host code, simulated clock)
# ---------------------------------------------------------------------------

SIM = "simulated (virtual clock)"
ENGINE_TUPLES, ENGINE_TXNS = 200_000, 300           # the Fig. 5 example's


def _tracked_writers(eng, n_fibers, keys_per_fiber):
    """Fibers writing values that name their txn into disjoint key
    slices, recording each acked txn, the last acked value of each key
    and every staged write."""
    acked, expect, staged = [], {}, {}

    def fiber(fid):
        rng = np.random.default_rng(1000 + fid)
        lo = fid * keys_per_fiber
        while True:
            t = eng.begin()
            key = lo + int(rng.integers(0, keys_per_fiber))
            val = struct.pack("<qq", t.id, key)
            val += bytes(eng.cfg.value_size - len(val))
            yield from t.update(key, val)
            staged[t.id] = (key, val)
            yield from eng.commit(t)
            acked.append(t.id)
            expect[key] = val

    return [fiber(f) for f in range(n_fibers)], acked, expect, staged


def _check_acked(what, get, expect, staged):
    """Every acknowledged write reads back, or a later txn that staged
    exactly the value found overwrote it (its COMMIT went durable before
    its ack resumed)."""
    for key, val in expect.items():
        v = get(key)
        if v == val:
            continue
        writer = struct.unpack_from("<q", v)[0] if v is not None else -1
        if not (writer > struct.unpack_from("<q", val)[0] and
                staged.get(writer) == (key, v)):
            raise AssertionError(f"{what}: acked write to key {key} lost")


def phase_engines():
    """The engines the paper's use cases run on, checked by their
    invariants (this script cannot import the JAX package the CPU tests
    hold them against). Host only; any failed check raises."""
    t0 = time.perf_counter()
    rungs = {c.name: c for c in EngineConfig.ladder()}
    ladder = {}
    for cfg in EngineConfig.ladder():     # Fig. 5: non-durable, one core
        if cfg.durability != "none" or cfg.n_cores > 1:
            continue
        eng = StorageEngine(dataclasses.replace(cfg, pool_frames=2048),
                            n_tuples=ENGINE_TUPLES)
        res = eng.run_fibers(lambda rng, e=eng: ycsb_update_txn(e, rng),
                             ENGINE_TXNS)
        assert res["txns"] == ENGINE_TXNS, (cfg.name, res["txns"])
        ladder[cfg.name] = res["tps"]
    if not ladder["+SQPoll"] > ladder["posix"]:
        raise AssertionError(f"Fig. 5 ladder: +SQPoll {ladder['+SQPoll']} "
                             f"tx/s not above posix {ladder['posix']}")
    log(f"engines: Fig. 5 ladder at {ENGINE_TUPLES} tuples, {ENGINE_TXNS} "
        f"txns, tx/s {SIM}: " +
        ", ".join(f"{k} {v:.1f}" for k, v in ladder.items()))

    # +GroupCommit: pull the plug mid-run, redo recovery
    eng = StorageEngine(dataclasses.replace(
        rungs["+GroupCommit"], n_fibers=32, pool_frames=128, ckpt_every=40),
        n_tuples=8_000)
    fibers, acked, expect, staged = _tracked_writers(eng, 32, 8_000 // 32)
    for f in fibers:
        eng.sched.spawn(f)
    eng.sched.run(until=lambda: eng.tl.now >= 40e-3)
    rec, rep = recover(*eng.crash_images(), pool_frames=512)
    missing = set(acked) - rep.winners
    assert acked and not missing, ("+GroupCommit recovery", missing)
    got = rec.get_many(sorted(expect))
    _check_acked("+GroupCommit recovery", got.get, expect, staged)
    group = {"acked": len(acked), "winners": len(rep.winners),
             "crash_at_s": eng.tl.now}

    # LSM: crash while a compaction is in flight
    lsm = make_engine(EngineConfig.lsm(n_fibers=32, pool_frames=256),
                      n_tuples=4_000, seed=0)
    fibers, l_acked, l_expect, l_staged = _tracked_writers(lsm, 16, 200)
    workers = [lsm.sched.spawn(f) for f in fibers]
    lsm.spawn_service_fibers(workers, done=lambda: False)
    lsm.sched.run(until=lambda: (lsm.compactor.jobs >= 1 and
                                 lsm.tl.now >= 6e-3))
    assert l_acked and lsm.flushes > 0 and lsm.compactor.jobs >= 1
    data, log_img = lsm.crash_images()
    lrec = recover_lsm(log_img, data)
    _check_acked("LSM recovery", lrec.get, l_expect, l_staged)
    lsm_res = {"acked": len(l_acked), "flushes": lsm.flushes,
               "compaction_jobs": lsm.compactor.jobs,
               "crash_at_s": lsm.tl.now}

    # +SyncRepl: fail over after a crash, and a quiesced standby
    def cluster():
        return ReplicatedCluster(dataclasses.replace(
            rungs["+SyncRepl"], n_fibers=16, pool_frames=256),
            n_tuples=4_000)
    cl = cluster()
    fibers, r_acked, r_expect, r_staged = _tracked_writers(cl.primary, 16,
                                                           4_000 // 16)
    cl.crash_run(fibers, steps=4_000)
    frec, frep = cl.standby.promote(durable_only=True, pool_frames=512)
    missing = set(r_acked) - frep.winners
    assert r_acked and not missing, ("+SyncRepl failover", missing)
    got = frec.get_many(sorted(r_expect))
    _check_acked("+SyncRepl failover", got.get, r_expect, r_staged)
    cl = cluster()
    res = cl.run(lambda rng, e=cl.primary: ycsb_update_txn(e, rng), 120)
    p, s = cl.primary.wal, cl.standby.wal
    assert p.durable_lsn == s.durable_lsn == cl.sender.shipped
    assert bytes(p.buf[:p.durable_lsn]) == bytes(s.buf[:s.durable_lsn])
    srec, _ = cl.standby.promote(pool_frames=512)
    prec, _ = recover(*cl.primary.crash_images(), pool_frames=512)
    if srec.get_many(range(4_000)) != prec.get_many(range(4_000)):
        raise AssertionError("+SyncRepl: the promoted standby differs from "
                             "the primary")
    repl = {"failover_acked": len(r_acked), "commit_wait_us":
            res["commit_wait_us"], "standby_commits": res["standby_commits"]}

    # the shuffle: the ring-driven engine against the closed-form oracle
    shuffle = {}
    for ts in (512, 4096):
        cfg = ShuffleConfig(n_nodes=3, n_workers=16, tuple_size=ts,
                            total_bytes_per_node=16 << 20)
        e_gib = ShuffleEngine(cfg).run()["egress_gib_per_node"]
        o_gib = ShuffleSim(cfg).run()["egress_gib_per_node"]
        if not 0.8 <= e_gib / o_gib <= 1.2:
            raise AssertionError(f"shuffle at {ts} B: engine {e_gib} GiB/s "
                                 f"vs oracle {o_gib}, outside 20%")
        shuffle[ts] = {"engine_gib_s": e_gib, "oracle_gib_s": o_gib}
    wall = time.perf_counter() - t0
    log(f"engines: +GroupCommit crash {SIM} at {group['crash_at_s']} s: "
        f"{group['acked']} acked txns, all read back by recover; LSM crash "
        f"during compaction {SIM} at {lsm_res['crash_at_s']} s "
        f"({lsm_res['flushes']} flushes, {lsm_res['compaction_jobs']} "
        f"compaction jobs): {lsm_res['acked']} acked, all read back by "
        f"recover_lsm; +SyncRepl failover: {repl['failover_acked']} acked, "
        f"none lost; quiesced standby equals the primary, commit wait "
        f"{repl['commit_wait_us']} us {SIM}; shuffle egress GiB/s/node "
        f"{SIM}, engine vs oracle: " +
        ", ".join(f"{ts} B {v['engine_gib_s']} vs {v['oracle_gib_s']}"
                  for ts, v in shuffle.items()) +
        f"; host wall {wall:.3f} s")
    return {"clock": SIM, "ladder_tx_per_s": ladder, "group_commit": group,
            "lsm": lsm_res, "sync_repl": repl, "shuffle": shuffle,
            "host_wall_s": wall}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    name, count, smi_line = phase_card_and_build()
    errs, extra_errs = phase_kernels_vs_plain(dev)
    free_card()
    phase_ring_cache(dev)
    phase_ring_cache(dev, window=RING_ANY_LEN, steps=RING_ANY_LEN + 1)
    free_card()
    launches, serve_times, pager = {}, {}, {}
    for arch in ARCHS:
        cfg, serve, prompts, launches[arch] = phase_main_path(dev, arch)
        serve_times[arch] = phase_serve_times(dev, arch, cfg, serve, prompts)
        if arch not in PROFILE_SKIP:
            phase_profile(dev, arch, cfg, serve, prompts)
        if arch in PAGER_ARCHS:
            free_card()
            launches[f"pager {arch}"], pager[arch] = phase_pager(
                dev, arch, cfg, serve, prompts)
        del serve
        free_card()
    train_times = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        for arch in TRAIN_ARCHS:
            corpus = make_synthetic_corpus(
                os.path.join(tmp, f"{arch}.bin"),
                corpus_tokens(get_config(arch)), get_config(arch).vocab_size,
                seed=0)
            cfg, loop, launches[f"train {arch}"], peak_gb = phase_train(
                dev, corpus, os.path.join(tmp, "ckpt_full"), arch)
            train_times[arch] = phase_train_times(dev, arch, cfg, loop,
                                                  corpus)
            train_times[arch]["peak_memory_gb"] = peak_gb
            del loop
            free_card()
            if arch in GRAD_ARCHS:
                train_times[arch]["grad_rel_l2_one_group"] = \
                    phase_train_grads(dev, corpus, arch)
                free_card()
            if arch in RESTART_ARCHS:
                phase_train_restart(dev, os.path.join(tmp, f"ckpt_{arch}"),
                                    arch)
                free_card()
        mesh_launches, mesh_results = phase_mesh(dev, tmp)
        launches.update(mesh_launches)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    times, extra_times = phase_kernel_times(dev)
    dryrun = phase_dryrun(train_times["stablelm-1.6b"]["step_ms"], smi_line)
    engines = phase_engines()
    paths = ARCHS + tuple(f"train {a}" for a in TRAIN_ARCHS) \
        + tuple(f"pager {a}" for a in PAGER_ARCHS) + tuple(mesh_launches)
    kernels = []
    for kname, src, replaces in (
            ("flash_attention_fwd", "src/repro_torch/csrc/flash_fwd.cu",
             "src/repro/kernels/flash_attention/kernel.py:71"),
            ("flash_attention_bwd", "src/repro_torch/csrc/flash_bwd.cu",
             "src/repro/models/attention.py:211"),
            ("paged_attention", "src/repro_torch/csrc/paged_attn.cu",
             "src/repro/kernels/paged_attn/kernel.py:70"),
            ("ssd_chunk_call", "src/repro_torch/csrc/ssd_chunk.cu",
             "src/repro/kernels/ssd_scan/kernel.py:73"),
            ("ssd_chunk_bwd", "src/repro_torch/csrc/ssd_bwd.cu",
             "src/repro/models/mamba.py:76")):
        ms, plain_ms, lib_ms, (bound_ms, bound_by) = times[kname]
        by_path = {a: launches[a][kname] for a in paths}
        entry = {"name": kname, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": sum(by_path.values()),
                 "launches_by_path": by_path, "max_abs_err": errs[kname],
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": lib_ms}
        if f"{kname} lse" in times:        # paged, writing lse as well
            l_ms, l_plain, _, (l_bound, _) = times[f"{kname} lse"]
            entry.update(lse_ms=l_ms, lse_plain_ms=l_plain,
                         lse_bound_ms=l_bound)
        if kname == "flash_attention_fwd":      # also at the training shape
            t_ms, t_plain, t_lib, (t_bound, _) = \
                times["flash_attention_fwd train"]
            entry.update(train_ms=t_ms, train_plain_ms=t_plain,
                         train_library_ms=t_lib, train_bound_ms=t_bound,
                         train_max_abs_err=errs[f"{kname} train"])
        # the other serving and training shapes: qwen2-vl's and mixtral's
        # GQA 6:1 at hd 128, deepseek-v2-lite's MLA head dims (prefill and
        # training), granite-34b's, yi-34b's and deepseek-67b's decode
        for label, tms in extra_times.items():
            sub = {}
            if kname in tms:
                k_ms, k_plain, k_lib, (k_bound, k_by) = tms[kname]
                sub.update(ms=k_ms, plain_ms=k_plain, bound_ms=k_bound,
                           bound_by=k_by, library_ms=k_lib)
            if f"{kname} lse" in tms:
                l_ms, l_plain, _, (l_bound, _) = tms[f"{kname} lse"]
                sub.update(lse_ms=l_ms, lse_plain_ms=l_plain,
                           lse_bound_ms=l_bound)
            if f"{kname} train" in tms:
                t_ms, t_plain, t_lib, (t_bound, _) = tms[f"{kname} train"]
                sub.update(train_ms=t_ms, train_plain_ms=t_plain,
                           train_library_ms=t_lib, train_bound_ms=t_bound)
            if kname in extra_errs[label]:
                sub["max_abs_err"] = extra_errs[label][kname]
            if f"{kname} train" in extra_errs[label]:
                sub["train_max_abs_err"] = extra_errs[label][f"{kname} train"]
            if sub:
                entry[label] = sub
        kernels.append(entry)
    by_path = {a: launches[a]["moe_slots"] for a in paths}
    log(f"moe_slots launches by path (counters): "
        f"{ {a: n for a, n in by_path.items() if n} }")
    kernels.append({"name": "moe_slots", "route": "cuda",
                    "source": "src/repro_torch/csrc/moe_slots.cu",
                    "replaces": "src/repro/models/moe.py:116",
                    "launches": sum(by_path.values()),
                    "launches_by_path": by_path,
                    "bit_identical": True, **{
                        label: dict(ms=ms, plain_ms=plain_ms,
                                    bound_ms=bnd[0], bound_by=bnd[1])
                        for label, (ms, plain_ms, _, bnd)
                        in times["moe_slots"].items()}})
    (ms, plain_ms, lib_ms, (bound_ms, bound_by)), passes = times["adamw"]
    by_path = {f"{a} {k}": launches[a][k] for a in paths
               for k in ("adamw_sumsq", "adamw_norm", "adamw_update_")
               if launches[a][k]}
    log(f"adamw launches by path (counters): {by_path}")
    kernels.append({"name": "adamw", "route": "cuda",
                    "source": "src/repro_torch/csrc/adamw.cu",
                    "replaces": "src/repro/optim/adamw.py:56",
                    "launches": sum(by_path.values()),
                    "launches_by_path": by_path,
                    "bit_identical": True, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, **passes})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels, "serve": serve_times,
                      "train": train_times, "pager": pager,
                      "mesh": mesh_results, "dryrun": dryrun,
                      "engines": engines}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
