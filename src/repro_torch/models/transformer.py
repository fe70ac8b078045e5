"""Transformer stacks: the uniform stack (dense and moe decoders, the
audio encoder), gemma3's local:global stack (groups of ``local_ratio``
sliding-window layers and one global layer, then a tail of local layers)
and the vlm's grouped stack (groups of ``cross_attn_every - 1`` self
layers and one tanh-gated cross-attention layer over vision tokens). The
reference's scan over stacked ``(L, ...)`` layer parameters is a Python
loop over the same stacked tensors, so the parameter tree keeps the
reference's shape. A moe layer has ``moe`` (``models/moe.py``, the local
path) where a dense layer has ``mlp``. Caches are updated in place. No
rematerialisation and no sharding constraints: one device, inference
only.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import Params, mlp, mlp_init, rmsnorm, rmsnorm_init
from repro_torch.models.moe import moe_ffn_local, moe_init


def unstack(sp: Params) -> list:
    """Stacked ``(L, ...)`` parameters as a list of L per-layer trees of
    views (one ``unbind`` per leaf, not one indexing per leaf and layer)."""
    if isinstance(sp, dict):
        parts = {k: unstack(v) for k, v in sp.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(sp.unbind(0))


# ===================================================================== #
#  One decoder layer (pre-norm attn + pre-norm FFN or MoE)               #
# ===================================================================== #
def layer_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16) -> Params:
    p = {"ln1": rmsnorm_init(cfg.d_model, gen.device),
         "ln2": rmsnorm_init(cfg.d_model, gen.device),
         "attn": attn.attn_init(gen, cfg.attn, cfg.d_model, dtype=dtype)}
    if cfg.family == "moe":
        p["moe"] = moe_init(gen, cfg, dtype)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype)
    return p


def _ffn(lp: Params, cfg: ModelConfig, y: torch.Tensor,
         n_real: Optional[torch.Tensor] = None):
    """The layer's FFN: (out, the MoE's aux loss) for the moe family, (out,
    None) for the MLP. ``n_real``: see ``moe.moe_ffn_local``."""
    if cfg.family == "moe":
        return moe_ffn_local(lp["moe"], cfg, y, n_real)
    return mlp(lp["mlp"], y, cfg.act), None


def layer_fwd(lp: Params, cfg: ModelConfig, x: torch.Tensor, *, kind: str,
              positions: Optional[torch.Tensor] = None):
    """Returns (x, (k, v), aux): the layer's keys and values feed the
    cache; aux is the MoE's load-balance loss, None for the MLP."""
    h, kv = attn.self_attention_block(
        lp["attn"], cfg.attn, rmsnorm(lp["ln1"], x, cfg.norm_eps),
        kind=kind, positions=positions)
    x = x + h
    f, aux = _ffn(lp, cfg, rmsnorm(lp["ln2"], x, cfg.norm_eps))
    return x + f, kv, aux


def layer_decode(lp: Params, cfg: ModelConfig, x, ck, cv, pos, *, kind: str = "causal"):
    h = attn.decode_self_attention(
        lp["attn"], cfg.attn, rmsnorm(lp["ln1"], x, cfg.norm_eps), ck, cv, pos, kind=kind)
    x = x + h
    return x + _ffn(lp, cfg, rmsnorm(lp["ln2"], x, cfg.norm_eps))[0]


# ===================================================================== #
#  Uniform stack (dense, moe)                                            #
# ===================================================================== #
def stack_init(draw, n: int) -> Params:
    """n trees drawn one after another by ``draw()``, stacked leaf by leaf
    into (n, ...) tensors. Each is copied into its place as it is drawn, so
    the stack and one tree are all that is ever held: a stack of 57 GB
    (moonshot-v1-16b-a3b) would not fit on an 80 GB card twice. n = 0
    gives empty ``(0, ...)`` stacks (one tree is drawn for their shapes),
    as the reference's vmap over no keys does."""
    first = draw()

    def alloc(t):
        return {k: alloc(v) for k, v in t.items()} if isinstance(t, dict) else \
            t.new_empty((n, *t.shape))

    def put(dst, src, i):
        if isinstance(src, dict):
            for k, v in src.items():
                put(dst[k], v, i)
        else:
            dst[i].copy_(src)

    stack = alloc(first)
    if n:
        put(stack, first, 0)
    del first
    for i in range(1, n):
        put(stack, draw(), i)
    return stack


def uniform_stack_init(gen: torch.Generator, cfg: ModelConfig,
                       dtype=torch.bfloat16) -> Params:
    """Stacked (L, ...) parameters, the shape of the reference's tree."""
    return stack_init(lambda: layer_init(gen, cfg, dtype), cfg.n_layers)


def _kind_for(cfg: ModelConfig) -> str:
    return "bidirectional" if cfg.is_encoder else "causal"


def uniform_stack_fwd(sp: Params, cfg: ModelConfig, x, *, collect_kv: bool = False):
    """Returns (x, aux, kvs): aux the MoE's load-balance loss summed over
    the layers (f32, 0 for the dense family), as the reference's scan
    carries it; kvs = (k (L,B,S,KVH,D), v (...)) if collect_kv."""
    kind = _kind_for(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs = [], []
    for lp in unstack(sp):
        x, (k, v), a = layer_fwd(lp, cfg, x, kind=kind)
        if a is not None:
            aux = aux + a
        if collect_kv:
            ks.append(k)
            vs.append(v)
    return x, aux, ((torch.stack(ks), torch.stack(vs)) if collect_kv else None)


def uniform_stack_extend(sp: Params, cfg: ModelConfig, x, cache_k, cache_v,
                         offsets: torch.Tensor):
    """Chunked prefill: run a chunk through the stack, extending the caches
    in place (the engine's path for continuous batching). x (1, C, d): c
    tokens padded to C rows; cache_{k,v}: (L, B_slots, Smax, KVH, D), the
    whole cache; offsets: an int64 tensor ``[slot, pos0, c]`` on the
    cache's device, read there, so that one captured step serves every
    chunk of C rows (the reference traces slot and pos0 the same way). The
    padding's keys and values go to the trash position Smax - 1, and the
    MoE routes only the c real rows, with the capacity of c tokens (the
    reference's extend sees exactly c)."""
    positions, rows = attn.chunk_rows(offsets, x.shape[1], cache_k.shape[2])
    for i, lp in enumerate(unstack(sp)):
        x = x + attn.extend_self_attention(
            lp["attn"], cfg.attn, rmsnorm(lp["ln1"], x, cfg.norm_eps),
            cache_k[i], cache_v[i], offsets, positions, rows)
        x = x + _ffn(lp, cfg, rmsnorm(lp["ln2"], x, cfg.norm_eps), offsets[2:])[0]
    return x


def uniform_stack_decode(sp: Params, cfg: ModelConfig, x, cache_k, cache_v, pos):
    for i, lp in enumerate(unstack(sp)):
        x = layer_decode(lp, cfg, x, cache_k[i], cache_v[i], pos)
    return x


# ===================================================================== #
#  local:global grouped stack (gemma3)                                   #
# ===================================================================== #
Cache = Dict[str, torch.Tensor]


def lg_split(cfg: ModelConfig) -> Tuple[int, int]:
    """(groups, local layers in the tail): a group is ``local_ratio`` local
    layers and one global layer; the layers left over are local."""
    r = cfg.attn.local_ratio
    g = cfg.n_layers // (r + 1)
    return g, cfg.n_layers - g * (r + 1)


def lg_stack_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16) -> Params:
    """``locals`` (g, r, ...), ``globals`` (g, ...), ``tail`` (tail, ...) or
    None: the reference's tree (with g = 0 the first two are empty)."""
    g, tail = lg_split(cfg)
    r = cfg.attn.local_ratio

    def draw():
        return layer_init(gen, cfg, dtype)
    return {"locals": stack_init(lambda: stack_init(draw, r), g),
            "globals": stack_init(draw, g),
            "tail": stack_init(draw, tail) if tail else None}


def to_ring(u: torch.Tensor, W: int) -> torch.Tensor:
    """A local layer's keys or values (B, S, KVH, D) as its cache holds them
    after the prompt: a ring of W rows with position p at slot p % W, the
    last W positions when S >= W, zero rows past S otherwise."""
    S = u.shape[1]
    if S >= W:
        inv = (torch.arange(W, device=u.device) - S) % W
        return u[:, S - W:].index_select(1, inv)
    return F.pad(u, (0, 0, 0, 0, 0, W - S))


def lg_stack_fwd(sp: Params, cfg: ModelConfig, x, *, collect_kv: bool = False):
    """Returns (x, aux, kvs): aux as ``uniform_stack_fwd``'s; kvs, if
    collect_kv, ((k, v) of the local layers (g, r, B, W, KVH, D) at their
    ring slots, (k, v) of the global layers (g, B, S, KVH, D), (k, v) of the
    tail (tail, B, W, KVH, D) or None), W = ``local_window`` whatever S is,
    as the reference collects them."""
    a = cfg.attn
    g, tail = lg_split(cfg)
    B, S = x.shape[:2]
    W = a.local_window
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if collect_kv:                 # filled layer by layer (empty where g = 0)
        def buf(*lead):
            return tuple(x.new_empty((*lead, a.n_kv_heads, a.head_dim)) for _ in "kv")
        local_kv, global_kv = buf(g, a.local_ratio, B, W), buf(g, B, S)
        tail_kv = buf(tail, B, W) if tail else None

    def run(lp, kind, dst):
        nonlocal x, aux
        x, kv, f = layer_fwd(lp, cfg, x, kind=kind)
        if f is not None:
            aux = aux + f
        if collect_kv:
            for d, u in zip(dst, kv):
                d.copy_(to_ring(u, W) if kind == "local" else u)

    for i, (lps, gp) in enumerate(zip(unstack(sp["locals"]), unstack(sp["globals"]))):
        for j, lp in enumerate(unstack(lps)):
            run(lp, "local", collect_kv and [t[i, j] for t in local_kv])
        run(gp, "causal", collect_kv and [t[i] for t in global_kv])
    if sp["tail"] is not None:
        for j, lp in enumerate(unstack(sp["tail"])):
            run(lp, "local", collect_kv and [t[j] for t in tail_kv])
    return x, aux, ((local_kv, global_kv, tail_kv) if collect_kv else None)


def lg_stack_decode(sp: Params, cfg: ModelConfig, x, cache: Cache, pos):
    """One token through the stack; the local rings (``local_{k,v}`` (g, r,
    B, W, ...), ``tail_{k,v}``) and the global caches (``global_{k,v}`` (g,
    B, Smax, ...)) are updated in place."""
    for i, (lps, gp) in enumerate(zip(unstack(sp["locals"]), unstack(sp["globals"]))):
        for j, lp in enumerate(unstack(lps)):
            x = layer_decode(lp, cfg, x, cache["local_k"][i, j], cache["local_v"][i, j], pos,
                             kind="local")
        x = layer_decode(gp, cfg, x, cache["global_k"][i], cache["global_v"][i], pos,
                         kind="causal")
    if sp["tail"] is not None:
        for j, lp in enumerate(unstack(sp["tail"])):
            x = layer_decode(lp, cfg, x, cache["tail_k"][j], cache["tail_v"][j], pos,
                             kind="local")
    return x


# ===================================================================== #
#  vlm grouped stack (n_self self layers + 1 gated cross-attn layer)     #
# ===================================================================== #
def vlm_split(cfg: ModelConfig) -> Tuple[int, int]:
    """(groups, self layers a group): every ``cross_attn_every``-th layer
    is a cross-attention layer; layers past the last whole group are
    dropped, as in the reference."""
    return cfg.n_layers // cfg.cross_attn_every, cfg.cross_attn_every - 1


def vlm_stack_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16) -> Params:
    """``selfs`` (g, n_self, ...) decoder layers and ``crosses`` (g, ...),
    each ``{ln, xattn (cross_attn_init), ln2, mlp}``: the reference's tree,
    drawn into preallocated stacks (``stack_init``)."""
    g, n_self = vlm_split(cfg)
    dev = gen.device

    def cross():
        return {"ln": rmsnorm_init(cfg.d_model, dev),
                "xattn": attn.cross_attn_init(gen, cfg.attn, cfg.d_model, cfg.d_vision, dtype),
                "ln2": rmsnorm_init(cfg.d_model, dev),
                "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype)}
    return {"selfs": stack_init(lambda: stack_init(lambda: layer_init(gen, cfg, dtype), n_self), g),
            "crosses": stack_init(cross, g)}


def _cross_layer_fwd(cp: Params, cfg: ModelConfig, x, vision, kv=None):
    x = x + attn.cross_attention_block(cp["xattn"], cfg.attn,
                                       rmsnorm(cp["ln"], x, cfg.norm_eps), vision, kv)
    return x + mlp(cp["mlp"], rmsnorm(cp["ln2"], x, cfg.norm_eps), cfg.act)


def vlm_stack_fwd(sp: Params, cfg: ModelConfig, x, vision, *, collect_kv: bool = False):
    """x (B, S, d) text, vision (B, T, d_vision). Returns (x, aux, kvs):
    aux 0 (no MoE), kvs, if collect_kv, ((k, v), (cross_k, cross_v)): the
    self layers' keys and values, each (g, n_self, B, S, KVH, D), filled
    layer by layer, and the vision tokens' as ``vlm_precompute_cross_kv``
    gives them, each (g, B, T, KVH, D), projected once and used by the
    cross layers too (the reference projects them a second time)."""
    a = cfg.attn
    g, n_self = vlm_split(cfg)
    B, S = x.shape[:2]
    if collect_kv:
        kvs = tuple(x.new_empty((g, n_self, B, S, a.n_kv_heads, a.head_dim)) for _ in "kv")
        cross = vlm_precompute_cross_kv(sp, cfg, vision)
    for i, (sps, cp) in enumerate(zip(unstack(sp["selfs"]), unstack(sp["crosses"]))):
        for j, lp in enumerate(unstack(sps)):
            x, kv, _ = layer_fwd(lp, cfg, x, kind="causal")
            if collect_kv:
                for d, u in zip(kvs, kv):
                    d[i, j].copy_(u)
        x = _cross_layer_fwd(cp, cfg, x, vision, (cross[0][i], cross[1][i]) if collect_kv else None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux, ((kvs, cross) if collect_kv else None)


def vlm_precompute_cross_kv(sp: Params, cfg: ModelConfig, vision):
    """The vision tokens (B, T, d_vision) through every cross layer's k and
    v projections once: (k, v), each (g, B, T, KVH, D)."""
    a = cfg.attn
    B, T, _ = vision.shape
    g = vlm_split(cfg)[0]
    kvs = tuple(vision.new_empty((g, B, T, a.n_kv_heads, a.head_dim)) for _ in "kv")
    for i, cp in enumerate(unstack(sp["crosses"])):
        for d, w in zip(kvs, (cp["xattn"]["wk"], cp["xattn"]["wv"])):
            d[i] = (vision @ w).reshape(B, T, a.n_kv_heads, a.head_dim)
    return kvs


def _cross_layer_decode(cp: Params, cfg: ModelConfig, x, ck, cv):
    """One token's cross layer over the cached vision keys and values (B,
    T, KVH, D): the query without RoPE (and without qk-norm, as in the
    reference's decode), every key valid, on the flash-decode kernel."""
    a, xp = cfg.attn, cp["xattn"]
    B = x.shape[0]
    q = (rmsnorm(cp["ln"], x, cfg.norm_eps) @ xp["wq"]).reshape(B, 1, a.n_heads, a.head_dim)
    kv_len = torch.full((B,), ck.shape[1], dtype=torch.int64, device=x.device)
    o = attn.decode_attention(q, ck, cv, kv_len).reshape(B, 1, -1) @ xp["wo"]
    x = x + torch.tanh(xp["gate"]).to(o.dtype) * o
    return x + mlp(cp["mlp"], rmsnorm(cp["ln2"], x, cfg.norm_eps), cfg.act)


def vlm_stack_decode(sp: Params, cfg: ModelConfig, x, cache: Cache, pos):
    """One token through the stack: the self layers' caches ``k``, ``v``
    (g, n_self, B, Smax, KVH, D) updated in place, the cross layers over
    ``cross_k``, ``cross_v`` (g, B, T_vision, KVH, D)."""
    for i, (sps, cp) in enumerate(zip(unstack(sp["selfs"]), unstack(sp["crosses"]))):
        for j, lp in enumerate(unstack(sps)):
            x = layer_decode(lp, cfg, x, cache["k"][i, j], cache["v"][i, j], pos)
        x = _cross_layer_decode(cp, cfg, x, cache["cross_k"][i], cache["cross_v"][i])
    return x
