"""A plain decoder in PyTorch: the reference that decides ``correct``.

It follows the published architecture of a GQA decoder, dense or with
sparse experts, and nothing of the program under test: pre-norm blocks
with RMSNorm, per-head RMSNorm of queries and keys where the configuration
has it (Qwen3), split-half rotary embeddings, causal softmax attention
with grouped key and value heads, a SwiGLU feed-forward (or softmax top-k
routing over SwiGLU experts, with each expert keeping at most ``capacity``
tokens of a group, in token order), a final RMSNorm and the unembedding.

It runs in float32 with TF32 off, one layer at a time: a layer's weights
are cast to float32 as it is reached, so that a model whose bf16 weights
fill most of the card still fits beside its reference. ``precision="fp8"``
is the control: every product's weights and inputs are rounded to float8
(e4m3, one scale per row of the input and per column of the weight), the
step below the bfloat16 that the configurations state.

Weights come in the nested layout that the benchmark draws them in
(``gpubench/weights.py``): ``embed``, ``final_ln`` and ``stack``, whose
leaves carry the layer index first.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

F8 = torch.float8_e4m3fn
F8_MAX = 448.0


def no_tf32() -> None:
    """float32 products in float32: TF32 would round their inputs to 10 bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale along ``dim``, back in f32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = F8_MAX / amax
    return (x * scale).to(F8).float() / scale


class Precision:
    """The products of the reference: float32, or float8 for the control."""

    def __init__(self, name: str):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.fp8 = name == "fp8"

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """A (d_in, d_out) or (E, d_in, d_out) weight as the products see it."""
        w = w.float()
        return _fp8(w, dim=-2) if self.fp8 else w

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., d_in) @ w (d_in, d_out), w already through ``weight``."""
        if self.fp8:
            x = _fp8(x, dim=-1)
        return x @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotation of x (S, H, D) at positions pos (S,)."""
    D = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, device=x.device, dtype=torch.float64) / D)
    ang = (pos.double()[:, None] * inv[None, :]).float()[:, None, :]
    c, s = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def attention(q, k, v, block: int = 1024) -> torch.Tensor:
    """Causal attention of q (S, H, D) over k, v (S, KVH, D), in query blocks."""
    S, H, D = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    out = torch.empty_like(q)
    kpos = torch.arange(S, device=q.device)
    for a in range(0, S, block):
        b = min(S, a + block)
        s = torch.einsum("qhd,khd->hqk", q[a:b], k[:b]) / math.sqrt(D)
        mask = kpos[None, :b] > torch.arange(a, b, device=q.device)[:, None]
        s = s.masked_fill(mask[None], float("-inf"))
        out[a:b] = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v[:b])
    return out


def swiglu(x, wg, wu, wd, P: Precision) -> torch.Tensor:
    return P.mm(torch.nn.functional.silu(P.mm(x, wg)) * P.mm(x, wu), wd)


def experts(x, lp: Dict, cfg: Dict, P: Precision, capacity: Optional[int]) -> torch.Tensor:
    """Softmax top-k routing of x (T, d) over SwiGLU experts. Each expert
    keeps its first ``capacity`` assignments in token order (None: all);
    a token's dropped assignment adds nothing."""
    m = cfg["moe"]
    E, k = m["n_experts"], m["top_k"]
    probs = torch.softmax(x @ lp["router"].float(), dim=-1)
    gates, ids = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    out = torch.zeros_like(x)
    for e in range(E):
        tok, slot = torch.nonzero(ids == e, as_tuple=True)   # in token order
        if capacity is not None:
            tok, slot = tok[:capacity], slot[:capacity]
        if tok.numel() == 0:
            continue
        y = swiglu(x[tok], P.weight(lp["w_gate"][e]), P.weight(lp["w_up"][e]),
                   P.weight(lp["w_down"][e]), P)
        out.index_add_(0, tok, y * gates[tok, slot, None])
    return out


def layer(x, pos, lp: Dict, cfg: Dict, P: Precision, capacity: Optional[int]) -> torch.Tensor:
    H, KVH, D = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    eps = cfg["norm_eps"]
    S = x.shape[0]
    a = lp["attn"]
    h = rmsnorm(x, lp["ln1"]["scale"], eps)
    q = P.mm(h, P.weight(a["wq"])).view(S, H, D)
    k = P.mm(h, P.weight(a["wk"])).view(S, KVH, D)
    v = P.mm(h, P.weight(a["wv"])).view(S, KVH, D)
    if cfg["qk_norm"]:
        q = rmsnorm(q, a["q_norm"], eps)
        k = rmsnorm(k, a["k_norm"], eps)
    q, k = rope(q, pos, cfg["rope_theta"]), rope(k, pos, cfg["rope_theta"])
    x = x + P.mm(attention(q, k, v).reshape(S, H * D), P.weight(a["wo"]))
    h = rmsnorm(x, lp["ln2"]["scale"], eps)
    if cfg["family"] == "moe":
        return x + experts(h, lp["moe"], cfg, P, capacity)
    f = lp["mlp"]
    return x + swiglu(h, P.weight(f["w_gate"]), P.weight(f["w_up"]), P.weight(f["w_down"]), P)


def _layer_params(stack: Dict, i: int) -> Dict:
    return {k: _layer_params(v, i) if isinstance(v, dict) else v[i] for k, v in stack.items()}


@torch.no_grad()
def logits(weights: Dict, cfg: Dict, tokens: torch.Tensor, at: torch.Tensor,
           precision: str = "f32", capacity: Optional[int] = None) -> torch.Tensor:
    """The f32 logits (len(at), V) at positions ``at`` of the sequence
    ``tokens`` (S,), each predicting the token after its position."""
    no_tf32()
    P = Precision(precision)
    emb = weights["embed"]["embedding"]
    pos = torch.arange(tokens.numel(), device=emb.device)
    x = emb[tokens.to(emb.device)].float()
    for i in range(cfg["n_layers"]):
        x = layer(x, pos, _layer_params(weights["stack"], i), cfg, P, capacity)
    h = rmsnorm(x[at.to(emb.device)], weights["final_ln"]["scale"], cfg["norm_eps"])
    w = weights["embed"].get("unembed")
    w = emb.t() if w is None else w
    return P.mm(h, P.weight(w))
