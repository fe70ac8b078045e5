"""Llama-3-405B — dense GQA decoder. [arXiv:2407.21783; unverified]

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    d_ff=53248,
    vocab_size=128256,
    attn=AttentionConfig(n_heads=128, n_kv_heads=8, head_dim=128,
                         rope_theta=500_000.0),
    tie_embeddings=False,
    source="arXiv:2407.21783; unverified",
)
