"""The pieces of the reference that no model owns: how products are taken
(``Prec``), the fp32 building blocks (rms norm, rotate-half RoPE, causal
attention, SwiGLU), the capacity and routing groups of the program's MoE
dispatch, the layers in the order the model runs them, and how far a
token's logit lies below the best. A model module (``reference/<name>``)
may import any of them.

``Prec`` is how products are taken: fp32, or, for the control, with each
operand rounded to fp8 (e4m3, one scale a tensor); rounded to bf16, it
stands in for the program's own precision as a witness.

A routing group is a row's whole prompt, or its 16 equal parts when the
length is a multiple of 16 and at least 1,024; at decode, the tokens of
every row at one position together.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from bench.weights import stacks

GROUPS = 16          # a long prompt's routing groups
GROUP_MIN = 1024     # the shortest prompt that is cut into them


class Prec:
    def __init__(self, fp8: bool = False, bf16: bool = False):
        self.fp8, self.bf16 = fp8, bf16

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            s = 448.0 / t.detach().abs().amax().clamp_min(1e-30)
            r = (t.detach() * s).to(torch.float8_e4m3fn).to(t.dtype) / s
        elif self.bf16:
            r = t.detach().to(torch.bfloat16).to(t.dtype)
        else:
            return t
        return t + (r - t.detach()) if t.requires_grad else r

    def mm(self, a, b):
        return self.q(a) @ self.q(b)


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x, pos, theta):
    """x (..., T, heads, d), pos (T,): rotate-half."""
    d = x.shape[-1]
    inv = torch.as_tensor(1.0 / (theta ** (np.arange(0, d, 2,
                                                     dtype=np.float64) / d)),
                          dtype=torch.float32, device=x.device)
    ang = pos.float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def attend(q, k, v, scale, prec, chunk=1024):
    """Causal attention; q (B, T, H, dq), k (B, T, KH, dq), v (B, T, KH,
    dv); query head h reads KV head h // (H / KH)."""
    B, T, H, _ = q.shape
    G = H // k.shape[2]
    kt = k.repeat_interleave(G, 2).permute(0, 2, 3, 1)
    vt = v.repeat_interleave(G, 2).permute(0, 2, 1, 3)
    keys = torch.arange(T, device=q.device)
    out = []
    for s0 in range(0, T, chunk):
        qc = q[:, s0:s0 + chunk].permute(0, 2, 1, 3)
        s = prec.mm(qc, kt) * scale
        rows = torch.arange(s0, s0 + qc.shape[2], device=q.device)
        s = s.masked_fill(keys[None] > rows[:, None], float("-inf"))
        out.append(prec.mm(torch.softmax(s, -1), vt))
    return torch.cat(out, 2).permute(0, 2, 1, 3)


def swiglu(x, w1, w3, w2, prec):
    return prec.mm(F.silu(prec.mm(x, w1)) * prec.mm(x, w3), w2)


def capacity(e: dict, n: int) -> int:
    """Slots an expert has in a routing group of ``n`` tokens."""
    c = int(n * e["top_k"] * e["capacity_factor"] / e["n_experts"])
    return max(8, min(((c + 7) // 8) * 8, n * e["top_k"]))


def prefill_groups(B: int, S: int, device):
    """(group id, order within the group) of each token of a (B, S)
    batch of prompts, as (B, S) tensors."""
    G = GROUPS if S % GROUPS == 0 and S >= GROUP_MIN else 1
    s = torch.arange(S, device=device)
    gid = torch.arange(B, device=device)[:, None] * G + (s // (S // G))[None]
    return gid, (s % (S // G))[None].expand(B, S)


def unit_groups(B: int, S0: int, T: int, device):
    """Routing groups of a generate's B rows of T tokens (a prompt of S0
    and its T - S0 decoded tokens): the prompt's groups, then each decode
    position's B tokens together, in row order."""
    gid, okey = prefill_groups(B, S0, device)
    n0 = int(gid.max()) + 1
    j = torch.arange(T - S0, device=device)
    gid = torch.cat([gid, (n0 + j)[None].expand(B, T - S0)], 1)
    okey = torch.cat([okey, torch.arange(B, device=device)[:, None]
                      .expand(B, T - S0)], 1)
    return gid, okey


def layer_list(m: dict):
    """(stack name, index in the stack, MoE layer?) for every layer."""
    return [(name, i, moe_layer) for name, n, moe_layer in stacks(m)
            for i in range(n)]


def gap_of(logits: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """How far below the reference's best each token's logit lies."""
    return logits.amax(-1) - logits.gather(-1, token[..., None].long())[..., 0]
