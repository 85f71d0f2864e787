"""granite-34b — dense llama-arch code model, MQA (GQA kv=1).

[arXiv:2405.04324; hf:ibm-granite/granite-34b-code-base]
88L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    arch_id="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    # 2-matrix GELU MLP (gpt_bigcode lineage): matches the published 34B
    # param count; SwiGLU with d_ff=24576 would be 47B.
    mlp_kind="gelu",
    microbatches=2,
)

SMOKE = CONFIG.replace(
    n_layers=4, d_model=128, n_heads=4, n_kv_heads=1, head_dim=32,
    d_ff=256, vocab_size=512, remat=False, microbatches=1,
)

register(CONFIG, SMOKE)
