"""Gemma-2B — dense decoder, GeGLU, MQA (kv=1), head_dim=256.

[arXiv:2403.08295; hf] 18L d_model=2048 8H (kv=1) d_ff=16384 vocab=256000.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    d_ff=16384,
    vocab_size=256000,
    attn=AttentionConfig(n_heads=8, n_kv_heads=1, head_dim=256,
                         rope_theta=10_000.0),
    act="geglu",
    embed_scale=True,
    tie_embeddings=True,
    source="arXiv:2403.08295; hf",
)
