"""Moonshot/Moonlight-16B-A3B — fine-grained MoE, 64 experts top-6 (+2 shared).

[hf:moonshotai/Moonlight-16B-A3B; hf] 48L d_model=2048 16H (GQA kv=16)
expert d_ff=1408 vocab=163840.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    d_ff=1408,
    vocab_size=163840,
    attn=AttentionConfig(n_heads=16, n_kv_heads=16, head_dim=128,
                         rope_theta=50_000.0),
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408,
                  n_shared_experts=2),
    tie_embeddings=True,
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
)
