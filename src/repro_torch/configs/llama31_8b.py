"""Llama-3.1-8B — paper workload (§4.2/§4.3 decode TBT experiments).

[hf:meta-llama/Llama-3.1-8B-Instruct] 32L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=128256.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama3.1-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=128256,
    attn=AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=128,
                         rope_theta=500_000.0),
    tie_embeddings=False,
    source="hf:meta-llama/Llama-3.1-8B-Instruct; paper workload",
)
