from repro_torch.configs.base import (  # noqa: F401
    AttentionConfig, ModelConfig, MoEConfig, RunConfig, SSMConfig,
    ShapeConfig, SHAPES, TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K,
    supports_shape,
)
