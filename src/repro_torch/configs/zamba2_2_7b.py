"""zamba2-2.7b — hybrid: Mamba2 backbone + shared (tied) attention block.

[arXiv:2411.15242; hf:Zyphra/Zamba2-2.7B]
54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64.
One shared attention+MLP block (tied weights) applied every 6 Mamba2 layers
(9 applications), the Zamba2 hallmark.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = ModelConfig(
    arch_id="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    head_dim=80,
    microbatches=2,
    mlp_kind="gelu",
    ssm=SSMConfig(d_state=64, expand=2, headdim=64, chunk=256),
    attn_every=6,
    shared_attn=True,
)

SMOKE = CONFIG.replace(
    n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=256, vocab_size=512, remat=False, microbatches=1,
    ssm=SSMConfig(d_state=16, expand=2, headdim=32, chunk=32),
    attn_every=2,
)

register(CONFIG, SMOKE)
