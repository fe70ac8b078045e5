"""Gemma3-4B — dense decoder with 5:1 local:global attention, 128k context.

[hf:google/gemma-3-*-pt; unverified] 34L d_model=2560 8H (GQA kv=4)
d_ff=10240 vocab=262144, head_dim=256, sliding window 1024 on local layers.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    d_ff=10240,
    vocab_size=262144,
    attn=AttentionConfig(n_heads=8, n_kv_heads=4, head_dim=256,
                         pattern="local_global", local_window=1024,
                         local_ratio=5, rope_theta=1_000_000.0),
    act="geglu",
    embed_scale=True,
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt; unverified",
)
