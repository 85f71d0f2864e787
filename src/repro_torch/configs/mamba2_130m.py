"""mamba2-130m — attention-free SSM with SSD (state-space duality).

[arXiv:2405.21060; hf:state-spaces/mamba2-130m; unverified]
24L d_model=768 (attn-free) vocab=50280, ssm_state=128.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = ModelConfig(
    arch_id="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, expand=2, headdim=64, chunk=256),
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=128, vocab_size=512, remat=False,
    ssm=SSMConfig(d_state=16, expand=2, headdim=32, chunk=32),
)

register(CONFIG, SMOKE)
