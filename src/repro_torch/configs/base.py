"""Model / shape configuration system (a copy of ``repro.configs.base``
that speaks ``torch`` dtypes, so the port never imports JAX).

Every assigned architecture is a :class:`ModelConfig`; input shapes are
:class:`ShapeConfig` entries from the shared LM shape set. The dry-run,
smoke tests, train/serve launchers and the roofline analysis all read from
this single source of truth.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch


# ---------------------------------------------------------------------------
# Shapes (shared across all LM-family archs; see brief)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0            # routed experts
    n_shared: int = 0             # always-on shared experts (DeepSeek style)
    top_k: int = 2
    d_ff_expert: int = 0          # per-expert hidden size
    first_k_dense: int = 0        # leading dense layers (DeepSeek-V2: 1)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention dims."""
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD dims."""
    d_state: int = 128
    expand: int = 2
    headdim: int = 64
    chunk: int = 256
    d_conv: int = 4

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.headdim


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    swa_window: int = 0              # 0 = full attention; >0 = sliding window
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    mlp_kind: str = "swiglu"         # swiglu | gelu
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_every: int = 0              # hybrid: one (shared) attn block every k
    shared_attn: bool = False        # hybrid: attn block weights are tied
    n_codebooks: int = 0             # audio: EnCodec codebooks (embed-sum)
    mrope_sections: Tuple[int, ...] = ()   # vlm: M-RoPE (t, h, w) dims
    # numerics / execution policy
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    attn_q_chunk: int = 512          # query-block size for chunked attention
    attn_schedule: str = "triangular"  # or "rect" (computes masked blocks)
    microbatches: int = 1            # gradient accumulation on the batch axis
    use_pallas: bool = False         # hot-path kernels (TPU); CPU uses jnp ref
    # ---- §Perf hillclimb levers (see EXPERIMENTS.md §Perf) ----
    bf16_stacked_params: bool = False  # cast layer stacks to bf16 BEFORE the
    #   scan: FSDP all-gathers move bf16, not fp32 (halves gather traffic)
    sp_norm: bool = False            # force norms to run sequence-sharded so
    #   the SP all-gather moves the bf16 normed activations, not fp32
    ssm_chunk: int = 0               # override cfg.ssm.chunk (SSD tiling)
    ssm_bf16: bool = False           # SSD L-matrix einsums in bf16
    # MoE dispatch: "gshard" = GSPMD constraint-flip resharding (baseline);
    # "shard_map" = explicit chunked all-to-all (distributed/a2a.py)
    moe_impl: str = "gshard"
    # shard expert FFN dim over `data` instead of FSDP on d_model: expert
    # matmuls then need NO weight gather per microbatch — only an output
    # all-reduce ~70x smaller (§Perf, mixtral)
    moe_fsdp_out: bool = False
    # int8 gradient compression with error feedback (optim/compression.py):
    # 4x less gradient-reduction traffic; EF residual added to opt state
    grad_compression: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.n_heads))

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run 500k-token decode? (SSM / hybrid-with-shared-attn
        over short windows only through paging / SWA-bounded KV)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.swa_window > 0

    def param_dt(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def compute_dt(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting (for 6ND roofline bookkeeping) ----------------
    def n_params(self, *, active_only: bool = False) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, L = self.d_model, self.n_layers
        total = self.vocab_size * d * (self.n_codebooks or 1)  # embeddings
        if not self.tie_embeddings:
            total += self.vocab_size * d * (self.n_codebooks or 1)
        total += d  # final norm
        per_attn = self._attn_params()
        per_mlp_dense = self._mlp_params(self.d_ff)

        if self.family == "ssm":
            total += L * self._ssm_params()
        elif self.family == "hybrid":
            n_attn = L // max(1, self.attn_every)
            total += L * self._ssm_params()
            shared = per_attn + per_mlp_dense + 2 * d
            total += shared if self.shared_attn else n_attn * shared
        elif self.family == "moe":
            m = self.moe
            per_expert = self._mlp_params(m.d_ff_expert)
            n_moe_layers = L - m.first_k_dense
            total += L * (per_attn + 2 * d)
            total += m.first_k_dense * per_mlp_dense
            router = d * m.n_experts
            always = m.n_shared * per_expert + router
            if active_only:
                total += n_moe_layers * (always + m.top_k * per_expert)
            else:
                total += n_moe_layers * (always + m.n_experts * per_expert)
        else:  # dense / vlm / audio
            total += L * (per_attn + per_mlp_dense + 2 * d)
        return int(total)

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.hd
        if self.mla is not None:
            m = self.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            down = d * (m.kv_lora_rank + m.qk_rope_head_dim)
            up = m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
            q = d * self.n_heads * qk
            o = self.n_heads * m.v_head_dim * d
            return down + up + q + o
        q = d * self.n_heads * hd
        kv = 2 * d * self.n_kv_heads * hd
        o = self.n_heads * hd * d
        return q + kv + o

    def _mlp_params(self, d_ff: int) -> int:
        if d_ff == 0:
            return 0
        n_in = 2 if self.mlp_kind == "swiglu" else 1
        return (n_in + 1) * self.d_model * d_ff

    def _ssm_params(self) -> int:
        s = self.ssm
        d, di, ns = self.d_model, s.d_inner(self.d_model), s.d_state
        nh = s.n_heads(d)
        in_proj = d * (2 * di + 2 * ns + nh)   # [z, x, B, C, dt]
        conv = s.d_conv * (di + 2 * ns)
        out = di * d
        extra = 2 * nh + di                    # A_log, D, norm
        return in_proj + conv + out + extra


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict = {}
_SMOKE: dict = {}


def register(cfg: ModelConfig, smoke: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.arch_id] = cfg
    _SMOKE[cfg.arch_id] = smoke
    return cfg


def get_config(arch_id: str) -> ModelConfig:
    _ensure_loaded()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def get_smoke_config(arch_id: str) -> ModelConfig:
    _ensure_loaded()
    return _SMOKE[arch_id]


def list_archs() -> list:
    _ensure_loaded()
    return sorted(_REGISTRY)


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Return (runs, reason-if-skipped) for an (arch, shape) cell."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "skipped(full-attention)"
    return True, ""


def cells(include_skipped: bool = False):
    """All (arch, shape) cells; 40 total, with skip annotations."""
    _ensure_loaded()
    out = []
    for a in list_archs():
        cfg = get_config(a)
        for s in SHAPES.values():
            ok, why = shape_applicable(cfg, s)
            if ok or include_skipped:
                out.append((a, s.name, ok, why))
    return out


def _ensure_loaded():
    if _REGISTRY:
        return
    from repro_torch.configs import (  # noqa: F401
        granite_34b, yi_34b, deepseek_67b, stablelm_1_6b,
        deepseek_v2_lite_16b, mixtral_8x22b, zamba2_2_7b, mamba2_130m,
        qwen2_vl_2b, musicgen_large,
    )
