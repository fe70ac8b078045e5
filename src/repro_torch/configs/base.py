"""Model / run configuration dataclasses.

Every assigned architecture is expressed as a frozen ``ModelConfig``.  The
same dataclass drives model construction
(``repro_torch.models.model.build_model``) and the serve engine's analytic
phase profiles (``repro_torch.serve.engine``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0        # hidden dim of each expert MLP
    n_shared_experts: int = 0   # always-on experts (moonlight-style)
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclass(frozen=True)
class SSMConfig:
    variant: str = "mamba1"     # "mamba1" | "mamba2"
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    # mamba2 only:
    n_heads: int = 0            # SSD heads; head_dim = d_inner // n_heads
    chunk_size: int = 128


@dataclass(frozen=True)
class AttentionConfig:
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qk_norm: bool = False
    rope_theta: float = 1_000_000.0
    # attention pattern: "global" | "local_global" (gemma3) | "bidirectional"
    pattern: str = "global"
    local_window: int = 1024
    local_ratio: int = 5        # local:global = local_ratio : 1
    softcap: float = 0.0        # logit softcapping (gemma2-style), 0 = off


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attn: AttentionConfig = field(default_factory=AttentionConfig)
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    act: str = "silu"           # "silu" | "gelu" | "geglu"
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    embed_scale: bool = False   # scale embeddings by sqrt(d_model) (gemma)
    is_encoder: bool = False    # encoder-only (hubert): bidirectional, no KV cache
    # vlm: every `cross_attn_every`-th layer is a cross-attention layer
    cross_attn_every: int = 0
    n_vision_tokens: int = 0    # stub frontend: precomputed patch embeddings
    d_vision: int = 0
    # hybrid (zamba2): one shared attention block applied every k ssm layers
    hybrid_attn_every: int = 0
    # numerics
    param_dtype: str = "bfloat16"
    activ_dtype: str = "bfloat16"
    # perf knobs (hillclimbable; can be overridden per shape via RunConfig)
    # "full" recomputes the layer in bwd (flash-attention-compatible: never
    # saves S^2 score tensors); "minimal" saves dot outputs; "none" = no remat
    remat_policy: str = "full"
    layer_group: int = 1    # checkpoint every g layers (B2)
    scan_layers: bool = True
    attn_impl: str = "auto"     # "auto" | "reference" | "flashref" | "pallas"
    source: str = ""            # provenance note

    # ------------------------------------------------------------------ #
    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def n_heads(self) -> int:
        return self.attn.n_heads

    @property
    def head_dim(self) -> int:
        return self.attn.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model

    def n_params(self) -> int:
        """Analytic total parameter count (matches init within ~1%)."""
        d, L, V = self.d_model, self.n_layers, self.vocab_size
        a = self.attn
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "audio"):
            qkvo = d * a.n_heads * a.head_dim * 2 + d * a.n_kv_heads * a.head_dim * 2
            n_mats = 3 if self.act in ("silu", "geglu") else 2
            if self.family == "moe":
                m = self.moe
                mlp = m.n_experts * (n_mats * d * m.d_ff_expert) + d * m.n_experts
                mlp += m.n_shared_experts * (n_mats * d * m.d_ff_expert)
            else:
                mlp = n_mats * d * self.d_ff
            per_layer = qkvo + mlp + 2 * d
            if self.family == "vlm" and self.cross_attn_every:
                n_cross = L // self.cross_attn_every
                cross = (d * a.n_heads * a.head_dim * 2
                         + self.d_vision * a.n_kv_heads * a.head_dim * 2 + d)
                emb += n_cross * cross
        elif self.family == "ssm":
            di, s = self.d_inner, self.ssm.d_state
            per_layer = (d * di * 2          # in_proj (x, z)
                         + di * self.ssm.d_conv
                         + di * s * 2        # B,C proj (via x_proj) approx
                         + di * (di // 16)   # dt_proj approx
                         + di * s            # A
                         + di * d            # out_proj
                         + 2 * d)
        elif self.family == "hybrid":
            di, s = self.d_inner, self.ssm.d_state
            per_layer = (d * di * 2 + di * self.ssm.d_conv + di * s * 2
                         + di + di * d + 2 * d)
            if self.hybrid_attn_every:
                qkvo = d * a.n_heads * a.head_dim * 2 + d * a.n_kv_heads * a.head_dim * 2
                emb += qkvo + 3 * d * self.d_ff + 2 * d   # one SHARED block
        return emb + L * per_layer

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if self.family != "moe":
            return self.n_params()
        d, L = self.d_model, self.n_layers
        m = self.moe
        n_mats = 3 if self.act in ("silu", "geglu") else 2
        dense_like = self.n_params() - L * m.n_experts * (n_mats * d * m.d_ff_expert)
        return dense_like + L * (m.top_k) * (n_mats * d * m.d_ff_expert)


# ---------------------------------------------------------------------- #
#  Input shapes (assigned shape set)                                      #
# ---------------------------------------------------------------------- #
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


@dataclass(frozen=True)
class RunConfig:
    """Per-(arch, shape) execution knobs — the hillclimb surface."""
    sharding_recipe: str = "auto"    # see parallel/sharding.py
    num_microbatches: int = 1
    remat_policy: Optional[str] = None   # override ModelConfig.remat_policy
    optimizer: str = "adamw"             # "adamw" | "adafactor"
    use_grad_compression: bool = False
    scan_unroll: int = 1
    layer_group: int = 0                 # 0 = model default
    attn_chunk: int = 1024               # flashref KV-chunk size
    decode_kv_seq_shards: int = 0        # 0 = recipe default


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """Applicability matrix (documented in DESIGN.md §4)."""
    if shape.kind == "decode" and cfg.is_encoder:
        return False
    if shape.name == "long_500k":
        subquadratic = (
            cfg.family in ("ssm", "hybrid")
            or cfg.attn.pattern == "local_global"
        )
        return subquadratic and not cfg.is_encoder
    return True
