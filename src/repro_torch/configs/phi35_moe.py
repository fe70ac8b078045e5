"""Phi-3.5-MoE (42B total, 6.6B active) — 16 experts, top-2.

[hf:microsoft/Phi-3.5-MoE-instruct; hf] 32L d_model=4096 32H (GQA kv=8)
expert d_ff=6400 vocab=32064.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    d_ff=6400,
    vocab_size=32064,
    attn=AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=128,
                         rope_theta=10_000.0),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=6400),
    tie_embeddings=False,
    source="hf:microsoft/Phi-3.5-MoE-instruct; hf",
)
