"""Shared building blocks: norms, RoPE, MLPs, embeddings, the loss.

Parameters are plain nested dicts of ``torch.Tensor`` with the reference's
nesting and shapes (weights are ``(d_in, d_out)`` and applied as ``x @ w``);
initialisers take an explicit ``torch.Generator``. Compute type is the
parameter type, with f32 for norms, softmax and logits.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _mesh, ops

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
    """Runs on the RMSNorm kernel for a CUDA tensor. Under a mesh the norm
    reads whole rows of the residual stream: the pending partial sums of a
    product split over its contraction (the attention's and the MLP's
    output projections over the model axis) are all-reduced, and a stream
    split over its features (``feature_shard_decode``'s layout) is
    gathered, first."""
    x, scale = _summed(x), p["scale"]
    if _mesh.is_dtensor(x):
        Replicate, mesh = _mesh._types()[2], x.device_mesh
        x = _mesh.placed(x, mesh, [
            Replicate() if _mesh.shard_dim(q, x.ndim) == x.ndim - 1 else q
            for q in x.placements])
        scale = _mesh.placed(scale, mesh, [Replicate()] * mesh.ndim)
    return ops.rmsnorm(x, scale, eps)


def _summed(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's ``Partial`` placements reduced (to ``Replicate``)."""
    if not _mesh.is_dtensor(x):
        return x
    Replicate, Partial = _mesh._types()[2:4]
    pl = [Replicate() if isinstance(p, Partial) else p for p in x.placements]
    return _mesh.placed(x, x.device_mesh, pl)


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
    if _mesh.is_dtensor(x):        # the tables, made whole on every rank
        cos, sin = (_mesh.replicated(t, x.device_mesh) for t in (cos, sin))
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


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d) @ w (d, n) as one product of x's rows, the fold ``matmul``
    makes of a plain tensor. Over DTensors the product runs on each rank's
    blocks (``_mesh.matmul``: Megatron's column and row splits, FSDP's
    gather), its rows folded there, on the local blocks."""
    def fold(x, w):
        return (x.reshape(-1, x.shape[-1]) @ w).reshape(*x.shape[:-1], w.shape[-1])
    return _mesh.matmul(fold, x, w) if _mesh.any_dtensor(x, w) else fold(x, w)


def mlp(p: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    up = linear(x, p["w_up"])
    if act == "silu":
        h = F.silu(linear(x, p["w_gate"])) * up
    elif act == "geglu":
        h = F.gelu(linear(x, p["w_gate"]), approximate="tanh") * up
    elif act == "gelu":
        h = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(f"unknown act {act!r}")
    return linear(h, p["w_down"])


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
    if _mesh.is_dtensor(p["embedding"]):
        x = _embed_sharded(p["embedding"], tokens)
    else:
        x = p["embedding"][tokens]
    if scale_by_dim:
        # the reference's scale rounded to x's dtype, as a Python number: a
        # tensor made on the card would be a host copy, which a CUDA graph
        # capture refuses (ROADMAP C20)
        x = x * torch.tensor(math.sqrt(x.shape[-1]), dtype=x.dtype).item()
    return x


def _embed_sharded(table, tokens):
    """The rows of ``tokens`` from a DTensor table (V, d) split over its
    vocabulary and / or its features, as the reference's compiler reads
    it: each rank looks up every id in its block of rows, the ids outside it
    masked to zero, and the partial rows are summed across the vocabulary's
    ranks. The ids, not the table, move: they are made whole on the mesh
    dims that split the table (the features stay split, as
    ``feature_shard_decode`` wants them). An id past the vocabulary raises
    on the CPU, as the one-device lookup does (ROADMAP C1)."""
    Shard, Replicate, Partial = _mesh._types()[1:4]
    mesh = table.device_mesh
    tp = table.placements
    ids_pl = [Replicate() if _mesh.shard_dim(t, 2) is not None else p
              for t, p in zip(tp, _mesh.placements(tokens, mesh))]
    tokens = _mesh.placed(_mesh.replicated(tokens, mesh), mesh, ids_pl)
    vocab = [i for i, t in enumerate(tp) if _mesh.shard_dim(t, 2) == 0]
    c, n = _mesh.coordinate(mesh, vocab)
    V = table.shape[0]
    Vl = V // n

    def look(t, ids):
        if ids.device.type == "cpu" and bool((ids >= V).any()):
            raise IndexError(f"token id past the vocabulary of {V}")
        i = ids - c * Vl
        ok = (i >= 0) & (i < Vl)
        return torch.where(ok[..., None], t[torch.clamp(i, 0, Vl - 1)], 0)
    nd = tokens.ndim + 1
    out = [Partial() if _mesh.shard_dim(t, 2) == 0 else
           Shard(nd - 1) if _mesh.shard_dim(t, 2) == 1 else p
           for t, p in zip(tp, ids_pl)]
    return _summed(_mesh.local(look, mesh, (table, tokens), out))


def _mm_out_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of one type, accumulated in f32 and returned in f32."""
    if a.dtype == torch.float32:
        return a @ b
    if a.device.type in ("cuda", "meta"):
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _MmF32(torch.autograd.Function):
    """``_mm_out_f32`` with the transpose rule of the reference's
    ``einsum(..., preferred_element_type=f32)``: dx in x's type and dw in
    w's type, both products accumulated in f32 (the f32 cotangent is
    rounded to the weights' type on the way in). PyTorch's ``mm`` with
    ``out_dtype`` has no derivative of its own ("derivative for aten::mm
    is not implemented", PyTorch 2.11 on the card)."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return _mm_out_f32(x2, w)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _mm_out_f32(g.to(w.dtype), w.t()).to(x2.dtype)
        if ctx.needs_input_grad[1]:
            dw = _mm_out_f32(x2.t(), g.to(x2.dtype)).to(w.dtype)
        return dx, dw


def _mm_f32(x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(n, d) @ (d, v) -> (n, v) f32, accumulated in f32 and never rounded
    to a narrower type. Casting a full-vocabulary weight to f32 would copy
    it on every call, so on the card a bf16 product asks the library for an
    f32 result directly, through ``_MmF32`` for its gradient."""
    if x2.dtype == torch.float32:
        return x2 @ w
    if x2.device.type in ("cuda", "meta"):      # meta: the card's product, counted
        return _MmF32.apply(x2, w)
    return x2.float() @ w.float()


def _mm_f32_sharded(x2, w):
    """``_mm_f32`` over DTensors, on each rank's blocks (``_mesh.matmul``),
    the partial sums of a split vocabulary's contraction summed."""
    return _summed(_mesh.matmul(_mm_f32, x2, w))


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Returns f32 logits."""
    w = p["unembed"] if "unembed" in p else p["embedding"].t()
    x2 = x.reshape(-1, x.shape[-1])
    mm = _mm_f32_sharded if _mesh.any_dtensor(x2, w) else _mm_f32
    return mm(x2, w).reshape(*x.shape[:-1], w.shape[1])


# --------------------------------------------------------------------- #
#  Loss                                                                  #
# --------------------------------------------------------------------- #
def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token CE. logits (..., V) f32, labels (...) integers; with
    ``mask`` the mean over the tokens it weighs."""
    logits = logits.float()
    if _mesh.is_dtensor(logits):
        # vocabulary split over ranks: the maximum, the sum of exps and the
        # gold logit each reduced across them (activation-sized), never the
        # logits gathered
        top = _summed(logits.detach().amax(dim=-1, keepdim=True))
        logz = torch.log(_summed(torch.exp(logits - top).sum(dim=-1))) + top[..., 0]
        gold = _summed(logits.gather(-1, labels[..., None].long()))[..., 0]
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()
