"""yi-34b — dense llama-arch with GQA.

[arXiv:2403.04652; hf:01-ai/Yi-34B]
60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    arch_id="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    head_dim=128,
    rope_theta=5_000_000.0,
    microbatches=2,
    mlp_kind="swiglu",
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=256, vocab_size=512, remat=False, microbatches=1,
)

register(CONFIG, SMOKE)
