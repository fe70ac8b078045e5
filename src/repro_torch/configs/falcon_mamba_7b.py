"""Falcon-Mamba-7B — attention-free Mamba-1 SSM LM.

[arXiv:2410.05355] 64L d_model=4096 vocab=65024 ssm_state=16, expand=2
(d_inner=8192), conv4.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    d_ff=0,
    vocab_size=65024,
    ssm=SSMConfig(variant="mamba1", d_state=16, d_conv=4, expand=2),
    tie_embeddings=False,
    source="arXiv:2410.05355; unverified",
)
