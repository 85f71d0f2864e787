"""musicgen-large — decoder-only LM over EnCodec tokens.

[arXiv:2306.05284; hf:facebook/musicgen-large]
48L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=2048.
Backbone only per the brief: the EnCodec frontend is a STUB — inputs are
4 parallel codebook token streams (delay pattern applied upstream);
embeddings of the K codebooks are summed per step.  Text conditioning
(T5 cross-attention) is out of scope for the backbone.
"""

from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    arch_id="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    head_dim=64,
    mlp_kind="gelu",
    n_codebooks=4,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=96, n_heads=4, n_kv_heads=4, head_dim=24,
    d_ff=192, vocab_size=128, remat=False, n_codebooks=4,
)

register(CONFIG, SMOKE)
