"""qwen2-vl-2b — VLM transformer backbone with M-RoPE.

[arXiv:2409.12191; hf:Qwen/Qwen2-VL-2B-Instruct]
28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.
Backbone only per the brief: the vision frontend is a STUB —
``input_specs()`` provides precomputed patch embeddings + 3D M-RoPE
position ids (temporal, height, width sections).
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    arch_id="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    rope_theta=1_000_000.0,
    mlp_kind="swiglu",
    mrope_sections=(16, 24, 24),    # t/h/w halves of the 64 rotary pairs
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab_size=512, remat=False,
    mrope_sections=(4, 6, 6),
)

register(CONFIG, SMOKE)
