"""The work of one call of each hand-written kernel: the bytes it must
move (each input read once, each output written once) and the operations
it does (a multiply-add counts 2), from shapes alone, and the least time
the card could take for it.

One count serves three readers: ``chip_smoke.py``'s ``bound()`` of each
kernel, the FLOP formulas the kernel ops register for ``FlopCounterMode``
and the byte formulas the dry run's counters read (``roofline.counters``).
A formula counts the function the kernel computes, not the instructions
its design issues (the SSD backward's split products are
``ssd_bwd_mma_work``, reported beside its bound).

Where the work depends on the data (the paged kernel reads a row's
``lengths`` positions), a caller that knows the data passes it; the op's
formula, which sees shapes only, takes every position the page table
holds (the dry run decodes at a full cache, where the two agree).
"""

from __future__ import annotations

from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16

# NVIDIA H100 SXM data sheet (dense, no sparsity), at the 700 W limit:
# published figures, not measurements
PEAK_FLOPS = {"bfloat16": PEAK_FLOPS_BF16, "float32": 67e12}
# the SSD kernels' products run on the tensor cores from split operands:
# their bound takes the function's operations at the TF32 rate
TF32_FLOPS = 495e12
# the bf16 SSD backward's operand pieces (exact, split): kernels/ssd_scan/
# ref.py's BWD_PIECES (a copy: this module imports no kernel module)
BWD_PIECES = (2, 3)


def bound_ms(n_bytes: float, flops: float, rate: float) -> tuple:
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    card's memory rate and the operations over ``rate``."""
    t_bytes, t_ops = n_bytes / HBM_BW, flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attended_pairs(S: int, Sk: int, causal: bool, window: int) -> int:
    """(query row, key) pairs the mask allows: key j for row i when
    j <= i (causal) and j > i - window (a window), as
    ``kernels/flash_attention/ref.py:allowed``."""
    if not causal and not window:
        return S * Sk
    total = 0
    if causal and not window and S <= Sk:
        return S * (S + 1) // 2
    for i in range(S):
        hi = min(i, Sk - 1) if causal else Sk - 1
        lo = max(0, i - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def flash_fwd_work(B, S, Sk, H, KH, hd, hdv, esz, *, with_lse=False,
                   causal=True, window=0):
    """q (B, S, H, hd), k (B, Sk, KH, hd), v (B, Sk, KH, hdv) read, o
    (B, S, H, hdv) and lse (B, H, S) fp32 written; Q·Kᵀ and P·V over the
    allowed pairs."""
    pairs = attended_pairs(S, Sk, causal, window)
    n_bytes = (B * S * H * (hd + hdv) * esz + B * Sk * KH * (hd + hdv) * esz
               + (B * H * S * 4 if with_lse else 0))
    return n_bytes, 2 * B * H * (hd + hdv) * pairs


def flash_bwd_work(B, S, Sk, H, KH, hd, hdv, esz, *, causal=True, window=0):
    """q, o, do, k, v and lse read, dq, dk, dv written; five products over
    the allowed pairs: S = Q·Kᵀ and dQ, dK over the q/k head dim, dP and
    dV over v's."""
    pairs = attended_pairs(S, Sk, causal, window)
    n_bytes = (B * S * H * (2 * hd + 2 * hdv) * esz
               + B * Sk * KH * (2 * hd + 2 * hdv) * esz + B * H * S * 4)
    return n_bytes, 2 * B * H * (3 * hd + 2 * hdv) * pairs


def paged_work(B, H, KH, hd, length, nblk, esz, *, with_lse=False):
    """K and V of ``length`` positions a row (each KV head's once), q read,
    out (and lse, fp32) written, the table (B, nblk) and lengths (B,)
    int32 read; q·k and p·v over the positions."""
    n_bytes = (2 * B * length * KH * hd * esz + 2 * B * H * hd * esz
               + B * nblk * 4 + B * 4 + (B * H * 4 if with_lse else 0))
    return n_bytes, 4 * B * H * hd * length


def ssd_work(B, S, nh, hp, ns, cl, esz):
    """One ssd_chunk_call: x, dt, A_log, B, C read, the fp32 pieces
    (y_diag, states, exp_cs, exp_tot) written; C Bᵀ once per chunk and the
    products only on the lower triangle, plus the elementwise x·dt, L
    (sub, exp, mul) and decay weights."""
    nc = S // cl
    tri = cl * (cl + 1) // 2
    n_bytes = (B * S * nh * hp * esz + B * S * nh * 4 + nh * 4
               + 2 * B * S * ns * esz                   # x, dt, A_log, B, C
               + B * S * nh * hp * 4 + B * nc * nh * hp * ns * 4
               + B * S * nh * 4 + B * nc * nh * 4)      # y, states, exps
    flops = (2 * B * nc * tri * ns + 2 * B * nc * nh * tri * hp
             + 3 * B * nc * nh * tri + 2 * B * S * nh * hp * ns
             + 2 * B * S * nh * hp + 2 * B * S * nh)
    return n_bytes, flops


def ssd_bwd_work(B, S, nh, hp, ns, cl, esz):
    """One ssd_chunk_bwd: x, dt, A_log, B, C and the four fp32 cotangents
    read, dx, ddt, dA_log, dB, dC written; on the lower triangle of each
    chunk s = C Bᵀ, dC and dB from ds once a chunk, g = dy xdtᵀ and
    dxdt += Pᵀ dy a head, dst B and the states' term of dB a head, plus
    the elementwise L, P, r and ds and the per-token dx, ddt."""
    nc = S // cl
    tri = cl * (cl + 1) // 2
    n_bytes = (2 * B * S * nh * hp * esz + 2 * B * S * nh * 4 + 2 * nh * 4
               + 4 * B * S * ns * esz                # x, dx, dt, ddt, A, B, C
               + B * S * nh * hp * 4 + B * nc * nh * hp * ns * 4
               + B * S * nh * 4 + B * nc * nh * 4)   # dy, dst, decs, detot
    flops = B * nc * (6 * tri * ns + 4 * nh * tri * hp
                      + 4 * nh * cl * hp * ns + 6 * nh * tri) \
        + 4 * B * S * nh * hp
    return n_bytes, flops


def ssd_bwd_mma_work(B, S, nh, hp, ns, cl):
    """bf16 tensor-core FLOPs the bf16 backward kernels issue (FMA = 2),
    the split passes and the padding of hp and ns to 32 and of the tiles
    to 64 included (csrc/ssd_bwd.cu): s once a tile pair and head group;
    dst B_j and x_j · dst a head and key tile; gᵀ and Pᵀ·dy a head and
    tile pair; dC and dB a tile pair."""
    pe, pb = BWD_PIECES
    hpp, nsp = -(-hp // 32) * 32, -(-ns // 32) * 32
    n_kt = -(-cl // 64)
    pairs, BC, ngrp = n_kt * (n_kt + 1) // 2, B * (S // cl), -(-nh // 8)
    tile = 64 * 64 * 2
    return BC * (ngrp * pairs * tile * nsp
                 + nh * n_kt * 2 * pe * 64 * hpp * nsp * 2
                 + nh * pairs * tile * hpp * (pe + pb * (pb + 1) // 2)
                 + pairs * 2 * pe * tile * nsp)


# ---------------------------------------------------------------------------
# the kernel ops' work from their arguments (tensors or shapes)
# ---------------------------------------------------------------------------

def moe_slots_work(BG, N, Ee):
    """eid (BG, N) int64 read; slot and dest (BG, N) int64, keep (BG, N)
    bool and kept (BG, Ee) int32 written: 8 B read and 17 B written a
    slot. Integers only: no operations."""
    return BG * N * (8 + 8 + 1 + 8) + BG * Ee * 4, 0


def adamw_sumsq_work(n, g_esz=4):
    """The norm pass: each of ``n`` gradient elements read once (4 B in
    fp32, 2 in bf16); the partials and the two scalars are noise.
    Elementwise: no operations counted."""
    return n * g_esz, 0


def adamw_norm_work(n, esz=8):
    """The finish: ``n`` partials read (fp64 on the card), gnorm and the
    clipping factor written. Elementwise: no operations counted."""
    return n * esz + 8, 0


def adamw_update_work(n, p_esz=4, g_esz=4):
    """The update pass: p, g, m and v read, p, m and v written, m and v in
    fp32: 28 B an element in fp32, 2 B less for each of p's two moves and
    g's read in bf16. Elementwise: no operations counted."""
    return n * (2 * p_esz + g_esz + 16), 0


def _shape(t):
    return tuple(t.shape) if hasattr(t, "shape") else tuple(t)


def _esz(t):
    return t.element_size() if hasattr(t, "element_size") else 2


def _flash_args(q, k, v):
    B, S, H, hd = _shape(q)
    _, Sk, KH, _ = _shape(k)
    return B, S, Sk, H, KH, hd, _shape(v)[-1]


def op_work(name: str, args) -> tuple:
    """(bytes, flops) of one call of the kernel op ``name``
    (``repro_torch::<name>``) on ``args``, its positional arguments as the
    op takes them (tensors, or shapes where no dtype is at hand: then 2
    bytes an element)."""
    if name in ("flash_fwd", "flash_fwd_lse"):
        q, k, v, causal, window = args[:5]
        return flash_fwd_work(*_flash_args(q, k, v), _esz(q),
                              with_lse=name == "flash_fwd_lse",
                              causal=causal, window=window)
    if name == "flash_bwd":
        q, k, v, _, _, _, causal, window = args[:8]
        return flash_bwd_work(*_flash_args(q, k, v), _esz(q), causal=causal,
                              window=window)
    if name in ("paged_attention", "paged_attention_lse"):
        q, kp, _, table = args[:4]
        B, H, hd = _shape(q)
        _, page_sz, KH, _ = _shape(kp)
        nblk = _shape(table)[1]
        return paged_work(B, H, KH, hd, nblk * page_sz, nblk, _esz(q),
                          with_lse=name == "paged_attention_lse")
    if name in ("ssd_chunk", "ssd_chunk_bwd"):
        x, B_ = args[0], args[3]
        chunk = args[-1]
        B, S, nh, hp = _shape(x)
        ns = _shape(B_)[-1]
        fn = ssd_work if name == "ssd_chunk" else ssd_bwd_work
        return fn(B, S, nh, hp, ns, min(chunk, S), _esz(x))
    if name == "moe_slots":
        BG, N = _shape(args[0])
        return moe_slots_work(BG, N, args[1])
    if name == "adamw_sumsq":
        return sum(adamw_sumsq_work(g.numel(), _esz(g))[0]
                   for g in args[0]), 0
    if name == "adamw_norm":
        return adamw_norm_work(args[0].numel(), _esz(args[0]))
    if name == "adamw_update_":
        return sum(adamw_update_work(p.numel(), _esz(p), _esz(g))[0]
                   for p, g in zip(args[0], args[1])), 0
    raise KeyError(name)


__all__ = ["PEAK_FLOPS", "TF32_FLOPS", "adamw_norm_work",
           "adamw_sumsq_work", "adamw_update_work", "attended_pairs", "bound_ms",
           "flash_bwd_work", "flash_fwd_work", "moe_slots_work", "op_work",
           "paged_work", "ssd_bwd_mma_work", "ssd_bwd_work", "ssd_work"]
