"""Gemma3-1B — paper workload (§4.4.2 of the paper uses Gemma3-1B-IT decode).

[hf:google/gemma-3-1b-pt] 26L d_model=1152 4H (kv=1) d_ff=6912 vocab=262144,
head_dim=256, 5:1 local:global with window 512.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    d_ff=6912,
    vocab_size=262144,
    attn=AttentionConfig(n_heads=4, n_kv_heads=1, head_dim=256,
                         pattern="local_global", local_window=512,
                         local_ratio=5, rope_theta=1_000_000.0),
    act="geglu",
    embed_scale=True,
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt; paper workload",
)
