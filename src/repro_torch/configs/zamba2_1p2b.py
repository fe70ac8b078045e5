"""Zamba2-1.2B — hybrid: Mamba-2 backbone + one SHARED attention block
applied every 6 SSM layers. [arXiv:2411.15242; hf]

38L d_model=2048 32H (kv=32, head_dim=64) d_ff=8192 vocab=32000 ssm_state=64.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    d_ff=8192,
    vocab_size=32000,
    attn=AttentionConfig(n_heads=32, n_kv_heads=32, head_dim=64,
                         rope_theta=10_000.0),
    ssm=SSMConfig(variant="mamba2", d_state=64, d_conv=4, expand=2,
                  n_heads=64, chunk_size=128),
    hybrid_attn_every=6,
    tie_embeddings=True,
    source="arXiv:2411.15242; hf",
)
