"""HuBERT X-Large — encoder-only audio transformer backbone.

[arXiv:2106.07447] 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (k-means
units). The conv waveform frontend is a STUB: ``input_specs`` feeds
precomputed frame embeddings of shape (B, T, d_model).
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    d_ff=5120,
    vocab_size=504,
    attn=AttentionConfig(n_heads=16, n_kv_heads=16, head_dim=80,
                         pattern="bidirectional", rope_theta=10_000.0),
    act="gelu",
    is_encoder=True,
    tie_embeddings=False,
    source="arXiv:2106.07447; unverified",
)
