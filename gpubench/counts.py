"""The yardstick's arithmetic: the card's published peaks, and the
operations and bytes that a step's inputs need.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at its
700 W limit): 989 TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM.
Every count is of the work the inputs need: padding rows, idle slots and
capacity slack are time and not work, so no share can pass 100%.
"""
from __future__ import annotations

from typing import Dict, Iterable

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16_BYTES = 2


def bound_s(bytes_moved: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory's rate and the operations over the bf16 peak."""
    return max(bytes_moved / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def product_params(s: Dict) -> Dict[str, float]:
    """Weights a token's products read: a layer's (the experts it is routed
    to and the router, for a moe layer), and the unembedding's."""
    d, H, KVH, D = s["d_model"], s["n_heads"], s["n_kv_heads"], s["head_dim"]
    attn = d * (H + 2 * KVH) * D + H * D * d
    if s["family"] == "moe":
        m = s["moe"]
        ffn = m["top_k"] * 3 * d * m["d_ff_expert"] + d * m["n_experts"]
    else:
        ffn = 3 * d * s["d_ff"]
    return {"layer": float(attn + ffn), "unembed": float(d * s["vocab_size"])}


def token_flops(s: Dict, pos: int, logits: bool) -> float:
    """A token at position ``pos`` (0-based) through the model: 2 x the
    product weights it meets, the unembedding only where its logits are
    wanted, plus causal attention over ``pos + 1`` keys (QK and PV)."""
    p = product_params(s)
    L, H, D = s["n_layers"], s["n_heads"], s["head_dim"]
    return (2.0 * (L * p["layer"] + (p["unembed"] if logits else 0.0))
            + 4.0 * L * H * D * (pos + 1))


def chunk_flops(s: Dict, c: int, pos0: int) -> float:
    """A prefill chunk of c tokens from pos0: its last token's logits only."""
    p = product_params(s)
    L, H, D = s["n_layers"], s["n_heads"], s["head_dim"]
    keys = c * pos0 + c * (c + 1) / 2          # sum of (pos + 1) over the chunk
    return 2.0 * (c * L * p["layer"] + p["unembed"]) + 4.0 * L * H * D * keys


def decode_attention_bytes(s: Dict, kv_lens: Iterable[int]) -> float:
    """``flash_decode`` over every layer for slots whose caches hold
    ``kv_lens`` keys: each valid key and value read once, each slot's query
    read and output written once."""
    L, H, KVH, D = s["n_layers"], s["n_heads"], s["n_kv_heads"], s["head_dim"]
    total = 0.0
    for n in kv_lens:
        total += 2 * n * KVH * D + 2 * H * D
    return L * BF16_BYTES * total


def chunk_attention(s: Dict, c: int, pos0: int) -> Dict[str, float]:
    """``flash_attention`` over every layer for a chunk's c real rows at
    pos0..: causal operations, and the bytes of the slot's pos0 + c keys
    and values, the chunk's queries and its output."""
    L, H, KVH, D = s["n_layers"], s["n_heads"], s["n_kv_heads"], s["head_dim"]
    keys = c * pos0 + c * (c + 1) / 2
    return {"flops": 4.0 * L * H * D * keys,
            "bytes": L * BF16_BYTES * (2 * (pos0 + c) * KVH * D + 2 * c * H * D)}
