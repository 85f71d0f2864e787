"""mixtral-8x22b — MoE, 8 experts top-2, sliding-window attention.

[arXiv:2401.04088; hf:mistralai/Mixtral-8x22B-v0.1]
56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8e top-2, SWA.
SWA window 4096 per the assignment's SWA note (Mixtral-8x7B lineage).
"""

from repro_torch.configs.base import MoEConfig, ModelConfig, register

CONFIG = ModelConfig(
    arch_id="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    head_dim=128,
    swa_window=4096,
    rope_theta=1_000_000.0,
    mlp_kind="swiglu",
    moe=MoEConfig(n_experts=8, n_shared=0, top_k=2, d_ff_expert=16384,
                  first_k_dense=0),
    # grad accumulation: 4 microbatches keep dispatch transients + saved
    # activations inside the 16 GB/chip budget at global batch 256
    microbatches=8,
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=256, vocab_size=512, swa_window=64, remat=False, microbatches=1,
    moe=MoEConfig(n_experts=4, n_shared=0, top_k=2, d_ff_expert=256,
                  first_k_dense=0),
)

register(CONFIG, SMOKE)
