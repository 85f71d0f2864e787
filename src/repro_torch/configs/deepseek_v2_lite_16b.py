"""deepseek-v2-lite-16b — MoE with Multi-head Latent Attention (MLA).

[arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2-Lite]
27L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400, MoE 64e top-6,
MLA kv_lora=512, 2 shared experts.

NOTE on the assignment line "2 shared+160 routed top-6": 160 routed experts
is the *full* DeepSeek-V2 (236B); V2-**Lite** has 64 routed experts
(matching the same line's "MoE 64e top-6"). We follow the Lite paper/HF
config: 64 routed + 2 shared, top-6, moe_intermediate=1408, first layer
dense (d_ff_dense=10944). Recorded in DESIGN.md §Arch-applicability.
"""

from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig, register

CONFIG = ModelConfig(
    arch_id="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,          # MLA: all heads share the latent KV; kept for bookkeeping
    d_ff=10944,             # dense-layer FFN (layer 0)
    vocab_size=102400,
    head_dim=128,
    mlp_kind="swiglu",
    moe=MoEConfig(
        n_experts=64, n_shared=2, top_k=6, d_ff_expert=1408, first_k_dense=1,
    ),
    mla=MLAConfig(
        kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
        v_head_dim=128,
    ),
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=256, vocab_size=512, remat=False,
    moe=MoEConfig(n_experts=8, n_shared=2, top_k=2, d_ff_expert=64,
                  first_k_dense=1),
    mla=MLAConfig(kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16,
                  v_head_dim=32),
)

register(CONFIG, SMOKE)
