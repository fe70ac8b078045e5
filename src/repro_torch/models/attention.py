"""GQA/MQA attention for the global and local (sliding-window) paths:
reference oracle, the kernel-backed prefill, chunked-prefill and decode
attention over a KV cache (a local layer's cache is a ring of its window's
rows), and the vlm family's tanh-gated cross attention over vision tokens.

Shape conventions:
  x        (B, S, d_model)
  q        (B, S, H, D)
  k, v     (B, T, KVH, D)

On a CUDA tensor ``run_attention`` and ``chunk_attention`` run on the
flash-attention kernel and ``decode_attention`` on the flash-decode
kernel (``repro_torch.kernels.ops``); on a CPU tensor the same entry
points compute the same functions with the kernels' plain versions. The
caches are updated in place.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import AttentionConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (Params, dense_init, l2norm, rope_tables,
                                       rotate)

NEG_INF = -1e30


# --------------------------------------------------------------------- #
#  Parameters                                                            #
# --------------------------------------------------------------------- #
def attn_init(gen: torch.Generator, a: AttentionConfig, d_model: int,
              d_kv_in: int = 0, dtype=torch.bfloat16) -> Params:
    """Self-attention when d_kv_in == 0, else cross-attention (keys and
    values projected from another width, e.g. the vision embeddings')."""
    d_kv_in = d_kv_in or d_model
    p = {
        "wq": dense_init(gen, d_model, a.n_heads * a.head_dim, dtype),
        "wk": dense_init(gen, d_kv_in, a.n_kv_heads * a.head_dim, dtype),
        "wv": dense_init(gen, d_kv_in, a.n_kv_heads * a.head_dim, dtype),
        "wo": dense_init(gen, a.n_heads * a.head_dim, d_model, dtype),
    }
    if a.qk_norm:
        p["q_norm"] = torch.ones((a.head_dim,), dtype=torch.float32, device=gen.device)
        p["k_norm"] = torch.ones((a.head_dim,), dtype=torch.float32, device=gen.device)
    return p


def cross_attn_init(gen: torch.Generator, a: AttentionConfig, d_model: int,
                    d_vision: int, dtype=torch.bfloat16) -> Params:
    p = attn_init(gen, a, d_model, d_kv_in=d_vision, dtype=dtype)
    p["gate"] = torch.zeros((), dtype=torch.float32, device=gen.device)  # tanh-gated residual
    return p


def project_qkv(p: Params, a: AttentionConfig, x: torch.Tensor,
                kv_x: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None, rope: bool = True,
                kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q from x (B, S, d); k and v from ``kv_x`` (B, T, d_kv_in), x itself
    when None, or ``kv``, those projections already made (B, T, KVH, D)."""
    kv_x = x if kv_x is None else kv_x
    B, S, _ = x.shape
    T = kv_x.shape[1]
    q = (x @ p["wq"]).reshape(B, S, a.n_heads, a.head_dim)
    if kv is None:
        k = (kv_x @ p["wk"]).reshape(B, T, a.n_kv_heads, a.head_dim)
        v = (kv_x @ p["wv"]).reshape(B, T, a.n_kv_heads, a.head_dim)
    else:
        k, v = kv
    if a.qk_norm:
        q = l2norm(q) * p["q_norm"].to(q.dtype)
        k = l2norm(k) * p["k_norm"].to(k.dtype)
    if rope:
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :]
        # q and k share positions and head size: one table serves both
        cos, sin = rope_tables(positions, a.head_dim, a.rope_theta)
        q, k = rotate(q, cos, sin), rotate(k, cos, sin)
    return q, k, v


# --------------------------------------------------------------------- #
#  Reference (oracle) attention                                          #
# --------------------------------------------------------------------- #
def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """GQA: repeat KV heads to the full head count."""
    KVH = k.shape[2]
    if KVH == n_heads:
        return k
    idx = torch.arange(n_heads, device=k.device) // (n_heads // KVH)
    return k[:, :, idx]


def reference_attention(q, k, v, kind: str = "causal", window: int = 0
                        ) -> torch.Tensor:
    """Plain attention over expanded KV heads: the oracle that the tests
    and the greedy full-forward generation use. No kernel on any device."""
    B, S, H, D = q.shape
    T = k.shape[1]
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) / math.sqrt(D)
    q_pos = torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(T, device=q.device)[None, :]
    if kind == "bidirectional":
        ok = torch.ones((S, T), dtype=torch.bool, device=q.device)
    elif kind == "causal":
        ok = k_pos <= q_pos
    elif kind == "local":
        ok = (k_pos <= q_pos) & (k_pos > q_pos - window)
    else:
        raise ValueError(kind)
    s = s + torch.where(ok, 0.0, NEG_INF)
    w = torch.softmax(s, dim=-1).to(v.dtype).float()
    o = torch.einsum("bhst,bthd->bshd", w, v.float())
    return o.to(q.dtype)


# --------------------------------------------------------------------- #
#  Kernel-backed attention                                               #
# --------------------------------------------------------------------- #
def run_attention(q, k, v, *, kind: str = "causal", window: int = 0,
                  softcap: float = 0.0) -> torch.Tensor:
    """Full-sequence attention (prefill / forward) on the flash-attention
    kernel."""
    return ops.flash_attention(q, k, v, kind=kind, window=window,
                               softcap=softcap)


def decode_attention(q, cache_k, cache_v, kv_len) -> torch.Tensor:
    """q: (B, 1, H, D); cache_{k,v}: (B, Smax, KVH, D); kv_len: () or (B,).
    One new token against the first ``kv_len[b]`` rows of each sequence's
    cache, on the flash-decode kernel."""
    return ops.flash_decode(q, cache_k, cache_v, kv_len)


def chunk_attention(q, cache_k, cache_v, offsets: torch.Tensor,
                    softcap: float = 0.0) -> torch.Tensor:
    """Chunked-prefill attention: the queries of a chunk of c tokens at
    absolute positions pos0.. (padded to C >= c rows) over the first pos0 +
    c rows of the cache row ``slot``, on the flash-attention kernel, which
    reads ``offsets = [slot, pos0, c]`` from device memory. A padded query
    sees every valid key and its output is never read.
    q: (1, C, H, D); cache_{k,v}: (B_slots, Smax, KVH, D), a layer's cache."""
    return ops.flash_attention(q, cache_k, cache_v, kind="causal",
                               softcap=softcap, offsets=offsets)


def self_attention_block(p: Params, a: AttentionConfig, x: torch.Tensor, *,
                         kind: str,
                         positions: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full self-attn block (proj -> attn -> out proj). Returns (out, (k, v))
    so prefill can populate the cache."""
    q, k, v = project_qkv(p, a, x, positions=positions)
    o = run_attention(q, k, v, kind=kind, window=a.local_window,
                      softcap=a.softcap)
    B, S = x.shape[:2]
    return o.reshape(B, S, -1) @ p["wo"], (k, v)


def cross_attention_block(p: Params, a: AttentionConfig, x: torch.Tensor,
                          vision: torch.Tensor,
                          kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                          ) -> torch.Tensor:
    """Tanh-gated cross attention of x (B, S, d) over precomputed vision
    tokens (B, T, d_vision): keys and values projected from ``vision``, no
    RoPE, bidirectional attention on the flash-attention kernel, and the
    output ``tanh(gate)`` (f32, cast to the output's type) times ``o @ wo``.
    The reference routes this call to its chunked jnp attention even when
    its kernel is asked for (``attn_impl="pallas"``); that computes the same
    function, and the port runs it on the kernel, as every attention.
    ``kv``: ``vision``'s k and v projections (B, T, KVH, D) where the
    caller has made them already (the prefill keeps them as its cache)."""
    q, k, v = project_qkv(p, a, x, kv_x=vision, rope=False, kv=kv)
    o = run_attention(q, k, v, kind="bidirectional")
    B, S = x.shape[:2]
    out = o.reshape(B, S, -1) @ p["wo"]
    return torch.tanh(p["gate"]).to(out.dtype) * out


def chunk_rows(offsets: torch.Tensor, C: int, smax: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The positions (1, C) of a chunk's C rows, ``pos0 + i``, and the flat
    cache rows (C,) that take their keys and values: row ``pos0 + i`` of
    slot ``slot`` for the c real tokens, the trash position ``smax - 1`` for
    the padding (so that a chunk whose bucket reaches past the cache writes
    nothing out of bounds). offsets: ``[slot, pos0, c]`` on the device."""
    i = torch.arange(C, device=offsets.device)
    pos = offsets[1] + i
    rows = offsets[0] * smax + torch.where(i < offsets[2], pos, smax - 1)
    return pos[None, :], rows


def extend_self_attention(p: Params, a: AttentionConfig, x: torch.Tensor,
                          cache_k, cache_v, offsets: torch.Tensor,
                          positions: torch.Tensor, rows: torch.Tensor
                          ) -> torch.Tensor:
    """Chunked-prefill step for one self-attn block: project the chunk's C
    rows (x (1, C, d)), write their k/v into the cache rows ``rows`` in
    place, attend over the valid prefix of the slot. cache_{k,v}: (B_slots,
    Smax, KVH, D), a layer's cache; offsets, positions and rows as
    ``chunk_rows`` gives them."""
    B, C = x.shape[:2]
    q, k, v = project_qkv(p, a, x, positions=positions)
    KVH, D = cache_k.shape[-2:]
    cache_k.view(-1, KVH, D).index_copy_(0, rows, k[0].to(cache_k.dtype))
    cache_v.view(-1, KVH, D).index_copy_(0, rows, v[0].to(cache_v.dtype))
    o = chunk_attention(q, cache_k, cache_v, offsets, softcap=a.softcap)
    return o.reshape(B, C, -1) @ p["wo"]


def write_kv(cache: torch.Tensor, new: torch.Tensor, idx: torch.Tensor) -> None:
    """Write (B,1,KVH,D) into (B,Smax,KVH,D) at position `idx` ((B,) tensor),
    in place."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, idx] = new[:, 0].to(cache.dtype)


def decode_self_attention(p: Params, a: AttentionConfig, x: torch.Tensor,
                          cache_k, cache_v, pos, *, kind: str = "causal") -> torch.Tensor:
    """One-token decode step for a self-attention block.

    x: (B, 1, d); cache_{k,v}: (B, Smax, KVH, D), updated in place; pos: int,
    () or (B,) — absolute position of the new token. A ``"local"`` layer's
    cache is a ring of Smax rows (its window): the new row goes to slot
    ``pos % Smax``, and every warm slot is valid, so the causal decode over
    ``min(pos + 1, Smax)`` rows is the window's attention. Returns the
    block's output."""
    B = x.shape[0]
    smax = cache_k.shape[1]
    pos = torch.as_tensor(pos, device=x.device).reshape(-1).expand(B)
    q, k, v = project_qkv(p, a, x, positions=pos[:, None])
    slot = pos % smax if kind == "local" else pos
    write_kv(cache_k, k, slot)
    write_kv(cache_v, v, slot)
    kv_len = torch.clamp(pos + 1, max=smax)
    o = decode_attention(q, cache_k, cache_v, kv_len)
    return o.reshape(B, 1, -1) @ p["wo"]
