"""stablelm-1.6b — dense, MHA (GQA kv=32 == n_heads).

[hf:stabilityai/stablelm-2-1_6b; unverified]
24L d_model=2048 32H (GQA kv=32) d_ff=5632 vocab=100352
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    arch_id="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    head_dim=64,
    mlp_kind="swiglu",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=96, n_heads=4, n_kv_heads=4, head_dim=24,
    d_ff=192, vocab_size=384, remat=False,
)

register(CONFIG, SMOKE)
