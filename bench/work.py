"""The benchmark's yardstick: the peaks of the card, each hand-written
kernel's bytes and operations from its shapes, and the operations a model
step needs.

The kernel formulas are frozen copies of the program's
``roofline/work.py`` (``flash_fwd_work``, ``flash_bwd_work``,
``paged_work``, ``attended_pairs``), kept here so that no change to the
program moves the yardstick. A multiply-add counts 2 operations; each
input byte is counted once and each output byte once.

The model operations count what the model needs from the
configuration's shapes: the matrix products of the active parameters
(a layer's from its model module's ``layer_matmul_params``: the routed
experts a token is sent to, never the capacity padding), the
causal attention over the pairs the mask allows, and the LM head only at
the positions whose logits are read. Training counts the forward three
times (forward, and the backward's two products); recomputation under
remat is not counted.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

from bench.weights import stacks

# the counts that take the model module first (``bind``)
MODEL_FLOPS = ("token_matmul_params", "forward_flops", "prefill_flops",
               "decode_flops", "generate_flops", "train_step_flops")

# NVIDIA H100 SXM data sheet, dense, no sparsity, at the 700 W limit
PEAK_FLOPS_BF16 = 989e12          # FLOP/s
HBM_BW = 3.35e12                  # B/s


def bound_s(n_bytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the bf16 rate."""
    return max(n_bytes / HBM_BW, flops / PEAK_FLOPS_BF16)


def attended_pairs(S: int, Sk: int, causal: bool, window: int) -> int:
    """(query row, key) pairs the mask allows: key j for row i when
    j <= i (causal) and j > i - window (a window)."""
    if not causal and not window:
        return S * Sk
    if causal and not window and S <= Sk:
        return S * (S + 1) // 2
    total = 0
    for i in range(S):
        hi = min(i, Sk - 1) if causal else Sk - 1
        lo = max(0, i - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def flash_fwd_work(B, S, Sk, H, KH, hd, hdv, esz, *, with_lse=False,
                   causal=True, window=0):
    """q (B, S, H, hd), k (B, Sk, KH, hd), v (B, Sk, KH, hdv) read, o
    (B, S, H, hdv) and lse (B, H, S) fp32 written; Q·Kᵀ and P·V over the
    allowed pairs. Returns (bytes, flops)."""
    pairs = attended_pairs(S, Sk, causal, window)
    n_bytes = (B * S * H * (hd + hdv) * esz + B * Sk * KH * (hd + hdv) * esz
               + (B * H * S * 4 if with_lse else 0))
    return n_bytes, 2 * B * H * (hd + hdv) * pairs


def flash_bwd_work(B, S, Sk, H, KH, hd, hdv, esz, *, causal=True, window=0):
    """q, o, do, k, v and lse read, dq, dk, dv written; five products over
    the allowed pairs."""
    pairs = attended_pairs(S, Sk, causal, window)
    n_bytes = (B * S * H * (2 * hd + 2 * hdv) * esz
               + B * Sk * KH * (2 * hd + 2 * hdv) * esz + B * H * S * 4)
    return n_bytes, 2 * B * H * (3 * hd + 2 * hdv) * pairs


def paged_work(B, H, KH, hd, length, nblk, esz, *, with_lse=False):
    """K and V of ``length`` positions a row read once, q read, out (and
    lse) written, the table (B, nblk) and lengths (B,) int32 read; q·k and
    p·v over the positions."""
    n_bytes = (2 * B * length * KH * hd * esz + 2 * B * H * hd * esz
               + B * nblk * 4 + B * 4 + (B * H * 4 if with_lse else 0))
    return n_bytes, 4 * B * H * hd * length


# ---------------------------------------------------------------------------
# model operations from the configuration's shapes
# ---------------------------------------------------------------------------

def attn_dims(m: dict) -> tuple:
    """(query/key head dim, value head dim) of the attention."""
    if m.get("mla"):
        a = m["mla"]
        return a["qk_nope_head_dim"] + a["qk_rope_head_dim"], a["v_head_dim"]
    return m["head_dim"], m["head_dim"]


def token_matmul_params(ref, m: dict) -> int:
    """Parameters a token multiplies through every layer (not the head),
    each layer's from the model module ``ref``."""
    return sum(n * ref.layer_matmul_params(m, moe_layer)
               for _, n, moe_layer in stacks(m))


def attention_flops(m: dict, pairs: int) -> int:
    """Q·Kᵀ and P·V over ``pairs`` (query, key) pairs in every layer."""
    qk, v = attn_dims(m)
    return 2 * m["n_layers"] * m["n_heads"] * (qk + v) * pairs


def forward_flops(ref, m: dict, tokens: int, pairs: int,
                  head_rows: int) -> int:
    """One forward over ``tokens`` positions attending ``pairs`` pairs, the
    head at ``head_rows`` positions."""
    return (2 * tokens * token_matmul_params(ref, m)
            + attention_flops(m, pairs)
            + 2 * head_rows * m["d_model"] * m["vocab_size"])


def prefill_flops(ref, m: dict, batch: int, prompt: int) -> int:
    """A batch of prompts of one length, the head read at the last."""
    return forward_flops(ref, m, batch * prompt,
                         batch * attended_pairs(prompt, prompt, True, 0),
                         batch)


def decode_flops(ref, m: dict, batch: int, pos: int) -> int:
    """One decode step of ``batch`` tokens at position ``pos`` (each
    attends pos + 1 keys)."""
    return forward_flops(ref, m, batch, batch * (pos + 1), batch)


def generate_flops(ref, m: dict, batch: int, prompt: int,
                   n_new: int) -> int:
    """A whole greedy generate: the prefill, then n_new - 1 decode steps."""
    return prefill_flops(ref, m, batch, prompt) + sum(
        decode_flops(ref, m, batch, prompt + j) for j in range(n_new - 1))


def train_step_flops(ref, m: dict, batch: int, seq: int) -> int:
    """One training step: three times the forward, the head at every
    position."""
    return 3 * forward_flops(ref, m, batch * seq,
                             batch * attended_pairs(seq, seq, True, 0),
                             batch * seq)


def bind(ref) -> SimpleNamespace:
    """This module as a metric's reader sees it (``ctx.work``), its model
    FLOP counts given the model module ``ref``."""
    ns = SimpleNamespace(**{k: v for k, v in globals().items()
                            if not k.startswith("_")})
    for k in MODEL_FLOPS:
        setattr(ns, k, functools.partial(globals()[k], ref))
    return ns
