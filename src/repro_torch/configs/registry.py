"""Architecture registry: ``get_config(name)`` / ``--arch <id>`` resolution."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import ModelConfig, ShapeConfig, SHAPES, supports_shape

from repro_torch.configs import (
    hubert_xlarge, falcon_mamba_7b, llama32_vision_90b, llama3_405b,
    gemma_2b, qwen3_1p7b, gemma3_4b, phi35_moe, moonshot_v1_16b,
    zamba2_1p2b, gemma3_1b, llama31_8b,
)

ASSIGNED: List[ModelConfig] = [
    hubert_xlarge.CONFIG,
    falcon_mamba_7b.CONFIG,
    llama32_vision_90b.CONFIG,
    llama3_405b.CONFIG,
    gemma_2b.CONFIG,
    qwen3_1p7b.CONFIG,
    gemma3_4b.CONFIG,
    phi35_moe.CONFIG,
    moonshot_v1_16b.CONFIG,
    zamba2_1p2b.CONFIG,
]

PAPER_WORKLOADS: List[ModelConfig] = [gemma3_1b.CONFIG, llama31_8b.CONFIG]

_REGISTRY: Dict[str, ModelConfig] = {c.name: c for c in ASSIGNED + PAPER_WORKLOADS}

# short aliases
_ALIASES = {
    "hubert": "hubert-xlarge",
    "falcon-mamba": "falcon-mamba-7b",
    "llama-vision": "llama-3.2-vision-90b",
    "llama-405b": "llama3-405b",
    "qwen3": "qwen3-1.7b",
    "phi-moe": "phi3.5-moe-42b-a6.6b",
    "moonshot": "moonshot-v1-16b-a3b",
    "zamba2": "zamba2-1.2b",
}


def get_config(name: str) -> ModelConfig:
    key = _ALIASES.get(name, name)
    if key not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def list_archs(assigned_only: bool = False) -> List[str]:
    return [c.name for c in (ASSIGNED if assigned_only else ASSIGNED + PAPER_WORKLOADS)]


def valid_cells() -> List[tuple]:
    """All (arch_name, shape_name) cells per the applicability matrix."""
    cells = []
    for cfg in ASSIGNED:
        for sname, shape in SHAPES.items():
            if supports_shape(cfg, shape):
                cells.append((cfg.name, sname))
    return cells


def tiny_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    kw = dict(
        n_layers=max(2, (cfg.hybrid_attn_every or 2)),
        d_model=64,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
    )
    attn = cfg.attn
    if attn.n_heads:
        ratio = max(1, attn.n_heads // max(attn.n_kv_heads, 1))
        kw["attn"] = attn.__class__(
            n_heads=4, n_kv_heads=max(1, 4 // ratio) if ratio > 1 else 4,
            head_dim=16, qk_norm=attn.qk_norm, rope_theta=attn.rope_theta,
            pattern=attn.pattern, local_window=8, local_ratio=attn.local_ratio,
        )
    if cfg.family == "moe":
        # capacity_factor 8: no token drops in tiny tests (parity checks)
        kw["moe"] = cfg.moe.__class__(
            n_experts=4, top_k=2, d_ff_expert=64,
            n_shared_experts=min(cfg.moe.n_shared_experts, 1),
            capacity_factor=8.0)
    if cfg.family in ("ssm", "hybrid"):
        kw["ssm"] = cfg.ssm.__class__(
            variant=cfg.ssm.variant, d_state=8, d_conv=4, expand=2,
            n_heads=4 if cfg.ssm.variant == "mamba2" else 0, chunk_size=16)
    if cfg.family == "vlm":
        kw["cross_attn_every"] = 5
        kw["n_layers"] = 10
        kw["n_vision_tokens"] = 16
        kw["d_vision"] = 32
    if cfg.family == "hybrid":
        kw["n_layers"] = 2 * cfg.hybrid_attn_every if cfg.hybrid_attn_every else 4
        kw["n_layers"] = min(kw["n_layers"], 12)
    return cfg.with_overrides(**kw)
