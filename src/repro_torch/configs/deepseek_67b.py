"""deepseek-67b — dense llama-arch with GQA.

[arXiv:2401.02954; hf:deepseek-ai/deepseek-llm-67b-base]
95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    arch_id="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    head_dim=128,
    microbatches=8,
    mlp_kind="swiglu",
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=320, vocab_size=640, remat=False, microbatches=1,
)

register(CONFIG, SMOKE)
