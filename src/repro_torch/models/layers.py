"""Shared building blocks: param declaration, norms, MLPs, rotary embeddings.

PyTorch counterpart of ``repro.models.layers``: same names, same tensor
layouts, same casts, so the two packages agree on the same inputs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Declarative parameters: one definition drives init and shapes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]     # logical axes, len == len(shape)
    init: str = "normal"                   # normal | zeros | ones | small
    scale: float = 1.0                     # fan-in style scale for "normal"
    dtype: str = "float32"

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def tree_map_defs(fn, defs):
    """Apply ``fn`` to every ParamDef leaf of a nested dict."""
    if isinstance(defs, ParamDef):
        return fn(defs)
    return {k: tree_map_defs(fn, v) for k, v in defs.items()}


def materialize(defs: dict, generator: torch.Generator,
                device="cuda") -> dict:
    """Real initialization on ``device``: N(0, scale²/fan_in) for "normal"
    leaves, drawn from ``generator`` (which must live on ``device``) in a
    fixed depth-first order, so one seed gives one tree. The numbers
    differ from ``jax.random``'s; tests carry JAX weights over instead
    (``repro_torch.interop``).

    A "normal" leaf that is not fp32 and is stacked (3 or more axes) is
    drawn one slice of its leading axis at a time into the preallocated
    leaf, so the fp32 draw never holds the whole leaf (mixtral-8x22b's
    stacked experts at 12 layers would take 38.6 GB in fp32 beside their
    19.3 GB in bf16); fp32 leaves are drawn whole."""

    def init_one(pd: ParamDef):
        dt = getattr(torch, pd.dtype)
        if pd.init == "zeros":
            return torch.zeros(pd.shape, dtype=dt, device=device)
        if pd.init == "ones":
            return torch.ones(pd.shape, dtype=dt, device=device)
        fan_in = pd.shape[-2] if len(pd.shape) >= 2 else pd.shape[-1]
        std = pd.scale / math.sqrt(max(1, fan_in))
        if dt == torch.float32 or len(pd.shape) < 3:
            w = torch.randn(pd.shape, generator=generator,
                            dtype=torch.float32, device=device)
            return w.mul_(std).to(dt)
        out = torch.empty(pd.shape, dtype=dt, device=device)
        for piece in out:
            piece.copy_(torch.randn(pd.shape[1:], generator=generator,
                                    dtype=torch.float32,
                                    device=device).mul_(std))
        return out

    return tree_map_defs(init_one, defs)


# ---------------------------------------------------------------------------
# Norms & MLPs (functional)
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-5):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def swiglu(x, w1, w3, w2, dtype):
    h = x @ w1.to(dtype)
    g = x @ w3.to(dtype)
    return (F.silu(h) * g) @ w2.to(dtype)


def gelu_mlp(x, w1, w2, dtype):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x @ w1.to(dtype), approximate="tanh") @ w2.to(dtype)


def mlp_defs(cfg, d_ff: int, prefix_logical_in="embed", ll=()) -> dict:
    """Param defs for one MLP; ``ll`` prepends stacked-layer axes."""
    d = cfg.d_model
    Lax = tuple("layers" for _ in ll)
    if cfg.mlp_kind == "swiglu":
        return {
            "w1": ParamDef(ll + (d, d_ff), Lax + ("embed", "mlp")),
            "w3": ParamDef(ll + (d, d_ff), Lax + ("embed", "mlp")),
            "w2": ParamDef(ll + (d_ff, d), Lax + ("mlp", "embed")),
        }
    return {
        "w1": ParamDef(ll + (d, d_ff), Lax + ("embed", "mlp")),
        "w2": ParamDef(ll + (d_ff, d), Lax + ("mlp", "embed")),
    }


def mlp_apply(cfg, p, x, dtype):
    if cfg.mlp_kind == "swiglu":
        return swiglu(x, p["w1"], p["w3"], p["w2"], dtype)
    return gelu_mlp(x, p["w1"], p["w2"], dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings (standard + M-RoPE) and sinusoidal positions
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                            / head_dim))


def rope_cos_sin(positions, head_dim: int, theta: float):
    """positions: (...,) int tensor → cos/sin of shape positions.shape +
    (hd/2,), fp32, on the device of ``positions``."""
    inv = torch.as_tensor(rope_freqs(head_dim, theta), dtype=torch.float32,
                          device=positions.device)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def mrope_cos_sin(pos3, head_dim: int, theta: float, sections):
    """Qwen2-VL M-RoPE. pos3: (3, B, S) temporal/height/width position ids.

    Frequency pairs are split into ``sections`` (t, h, w); each section
    rotates by its own position stream. Returns cos/sin (B, S, hd/2).
    """
    assert sum(sections) == head_dim // 2, (sections, head_dim)
    cos_t, sin_t = rope_cos_sin(pos3, head_dim, theta)   # (3, B, S, hd/2)
    cos_p, sin_p, start = [], [], 0
    for i, sec in enumerate(sections):
        cos_p.append(cos_t[i, :, :, start:start + sec])
        sin_p.append(sin_t[i, :, :, start:start + sec])
        start += sec
    return torch.cat(cos_p, -1), torch.cat(sin_p, -1)


def apply_rope(x, cos, sin):
    """x: (..., S, H, hd); cos/sin (S, hd/2) for text rope or (B, S, hd/2)
    for M-RoPE — rotate-half split."""
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    if cos.ndim == 2:        # (S, hd/2) — text rope
        cos = cos[:, None, :]
        sin = sin[:, None, :]
    elif cos.ndim == 3:      # (B, S, hd/2) — M-RoPE
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n_pos: int, d_model: int) -> np.ndarray:
    """MusicGen-style absolute sinusoidal embedding table (numpy, computed
    in float64 and stored as float32, as the JAX package's)."""
    pos = np.arange(n_pos)[:, None]
    dim = np.arange(0, d_model, 2)[None, :]
    ang = pos / np.power(10_000, dim / d_model)
    out = np.zeros((n_pos, d_model), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out


def padded_vocab(v: int, multiple: int = 128) -> int:
    return ((v + multiple - 1) // multiple) * multiple
