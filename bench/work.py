"""The benchmark's yardstick: the peaks of the card, each hand-written
kernel's bytes and operations from its shapes, and the operations a model
step needs.

The kernel formulas are frozen copies of the program's
``roofline/work.py`` (``flash_fwd_work``, ``flash_bwd_work``,
``paged_work``, ``attended_pairs``), kept here so that no change to the
program moves the yardstick. A multiply-add counts 2 operations; each
input byte is counted once and each output byte once.

The model operations (``model_flops``) count what the model needs from
the configuration's shapes: the matrix products of the active parameters
(the routed experts a token is sent to, never the capacity padding), the
causal attention over the pairs the mask allows, and the LM head only at
the positions whose logits are read. Training counts the forward three
times (forward, and the backward's two products); recomputation under
remat is not counted.
"""

from __future__ import annotations

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


def layer_matmul_params(m: dict, moe_layer: bool) -> int:
    """Parameters one token multiplies in one layer: the attention's
    projections and, in an MoE layer, the router, the top-k routed experts
    and the shared ones (else the dense MLP)."""
    d, H = m["d_model"], m["n_heads"]
    if m.get("mla"):
        a = m["mla"]
        qk = a["qk_nope_head_dim"] + a["qk_rope_head_dim"]
        attn = (d * H * qk + d * (a["kv_lora_rank"] + a["qk_rope_head_dim"])
                + a["kv_lora_rank"] * H * (a["qk_nope_head_dim"]
                                           + a["v_head_dim"])
                + H * a["v_head_dim"] * d)
    else:
        hd, KH = m["head_dim"], m["n_kv_heads"]
        attn = 2 * d * H * hd + 2 * d * KH * hd
    if moe_layer:
        e = m["moe"]
        ffn = (d * e["n_experts"]
               + (e["top_k"] + e.get("n_shared", 0)) * 3 * d
               * e["d_ff_expert"])
    else:
        ffn = 3 * d * m["d_ff"]
    return attn + ffn


def token_matmul_params(m: dict) -> int:
    """Parameters a token multiplies through every layer (not the head)."""
    fk = m["moe"].get("first_k_dense", 0) if m.get("moe") else 0
    n_moe = m["n_layers"] - fk if m.get("moe") else 0
    return (fk * layer_matmul_params(m, False)
            + n_moe * layer_matmul_params(m, True)
            + (0 if m.get("moe") else
               m["n_layers"] * layer_matmul_params(m, False)))


def attention_flops(m: dict, pairs: int) -> int:
    """Q·Kᵀ and P·V over ``pairs`` (query, key) pairs in every layer."""
    qk, v = attn_dims(m)
    return 2 * m["n_layers"] * m["n_heads"] * (qk + v) * pairs


def forward_flops(m: dict, tokens: int, pairs: int, head_rows: int) -> int:
    """One forward over ``tokens`` positions attending ``pairs`` pairs, the
    head at ``head_rows`` positions."""
    return (2 * tokens * token_matmul_params(m) + attention_flops(m, pairs)
            + 2 * head_rows * m["d_model"] * m["vocab_size"])


def prefill_flops(m: dict, batch: int, prompt: int) -> int:
    """A batch of prompts of one length, the head read at the last."""
    return forward_flops(m, batch * prompt,
                         batch * attended_pairs(prompt, prompt, True, 0),
                         batch)


def decode_flops(m: dict, batch: int, pos: int) -> int:
    """One decode step of ``batch`` tokens at position ``pos`` (each
    attends pos + 1 keys)."""
    return forward_flops(m, batch, batch * (pos + 1), batch)


def generate_flops(m: dict, batch: int, prompt: int, n_new: int) -> int:
    """A whole greedy generate: the prefill, then n_new - 1 decode steps."""
    return prefill_flops(m, batch, prompt) + sum(
        decode_flops(m, batch, prompt + j) for j in range(n_new - 1))


def train_step_flops(m: dict, batch: int, seq: int) -> int:
    """One training step: three times the forward, the head at every
    position."""
    return 3 * forward_flops(m, batch * seq,
                             batch * attended_pairs(seq, seq, True, 0),
                             batch * seq)
