"""Llama-3.2-Vision-90B — decoder LM backbone with interleaved cross-attn
image layers. [hf:meta-llama/Llama-3.2-11B-Vision scaled; unverified]

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256. Every 5th layer is
a cross-attention layer over vision tokens (20 cross layers). The vision
encoder is a STUB: precomputed patch embeddings (B, n_vision_tokens, d_vision).
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    d_ff=28672,
    vocab_size=128256,
    attn=AttentionConfig(n_heads=64, n_kv_heads=8, head_dim=128,
                         rope_theta=500_000.0),
    cross_attn_every=5,
    n_vision_tokens=4096,
    d_vision=1280,
    tie_embeddings=False,
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)
