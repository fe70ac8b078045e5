"""Qwen3-1.7B — dense decoder with QK-norm and GQA.

[hf:Qwen/Qwen3-8B family; hf] 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936, qk_norm.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    d_ff=6144,
    vocab_size=151936,
    attn=AttentionConfig(n_heads=16, n_kv_heads=8, head_dim=128,
                         qk_norm=True, rope_theta=1_000_000.0),
    tie_embeddings=True,
    source="hf:Qwen/Qwen3-8B; hf",
)
