"""Shared building blocks: norms, RoPE, MLPs, embeddings.

Parameters are plain nested dicts of ``torch.Tensor`` with the reference's
nesting and shapes (weights are ``(d_in, d_out)`` and applied as ``x @ w``);
initialisers take an explicit ``torch.Generator``. Compute type is the
parameter type, with f32 for norms, softmax and logits.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

Params = Dict[str, torch.Tensor]


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def _normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (x * scale).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.bfloat16) -> torch.Tensor:
    return _normal(gen, (d_in, d_out), 1.0 / math.sqrt(d_in), dtype)


# --------------------------------------------------------------------- #
#  RMSNorm                                                               #
# --------------------------------------------------------------------- #
def rmsnorm_init(d: int, device, dtype=torch.float32) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Runs on the RMSNorm kernel for a CUDA tensor."""
    return ops.rmsnorm(x, p["scale"], eps)


def l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-head QK-norm (qwen3-style, scale-free variant)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype)


# --------------------------------------------------------------------- #
#  Rotary position embedding                                             #
# --------------------------------------------------------------------- #
def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos and sin of the rotation angles, (..., S, 1, D/2) in f32, for
    positions broadcastable to (..., S)."""
    freqs = rope_frequencies(head_dim, theta, positions.device)  # (D/2,)
    angles = positions[..., None].float() * freqs                # (..., S, D/2)
    angles = angles[..., None, :]                                # (..., S, 1, D/2)
    return torch.cos(angles), torch.sin(angles)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Split-half rotation of x (..., S, H, D), computed in f32 and cast
    back."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))


# --------------------------------------------------------------------- #
#  MLP (silu / gelu / geglu)                                             #
# --------------------------------------------------------------------- #
def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, act: str,
             dtype=torch.bfloat16) -> Params:
    p = {"w_up": dense_init(gen, d_model, d_ff, dtype),
         "w_down": dense_init(gen, d_ff, d_model, dtype)}
    if act in ("silu", "geglu"):
        p["w_gate"] = dense_init(gen, d_model, d_ff, dtype)
    return p


def mlp(p: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    up = x @ p["w_up"]
    if act == "silu":
        h = F.silu(x @ p["w_gate"]) * up
    elif act == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * up
    elif act == "gelu":
        h = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(f"unknown act {act!r}")
    return h @ p["w_down"]


# --------------------------------------------------------------------- #
#  Embedding / unembedding                                               #
# --------------------------------------------------------------------- #
def embed_init(gen: torch.Generator, vocab: int, d_model: int, tie: bool,
               dtype=torch.bfloat16) -> Params:
    p = {"embedding": _normal(gen, (vocab, d_model), 1.0 / math.sqrt(d_model), dtype)}
    if not tie:
        p["unembed"] = dense_init(gen, d_model, vocab, dtype)
    return p


def embed(p: Params, tokens: torch.Tensor, scale_by_dim: bool = False
          ) -> torch.Tensor:
    x = p["embedding"][tokens]
    if scale_by_dim:
        x = x * torch.tensor(math.sqrt(x.shape[-1]), dtype=x.dtype, device=x.device)
    return x


def _mm_f32(x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(n, d) @ (d, v) -> (n, v) f32, accumulated in f32 and never rounded
    to a narrower type. Casting a full-vocabulary weight to f32 would copy
    it on every call, so on the card a bf16 product asks the library for an
    f32 result directly."""
    if x2.dtype == torch.float32:
        return x2 @ w
    if x2.device.type == "cuda":
        return torch.mm(x2, w, out_dtype=torch.float32)
    return x2.float() @ w.float()


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Returns f32 logits."""
    w = p["unembed"] if "unembed" in p else p["embedding"].t()
    x2 = x.reshape(-1, x.shape[-1])
    return _mm_f32(x2, w).reshape(*x.shape[:-1], w.shape[1])
