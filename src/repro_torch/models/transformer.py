"""Transformer stacks: the uniform stack (dense and moe decoders, the
audio encoder), gemma3's local:global stack (groups of ``local_ratio``
sliding-window layers and one global layer, then a tail of local layers)
and the vlm's grouped stack (groups of ``cross_attn_every - 1`` self
layers and one tanh-gated cross-attention layer over vision tokens). The
reference's scan over stacked ``(L, ...)`` layer parameters is a Python
loop over the same stacked tensors, so the parameter tree keeps the
reference's shape. A moe layer has ``moe`` (``models/moe.py``) where a dense layer has
``mlp``. Caches are updated in place.

Every stack takes the reference's ``ctx`` (a ``ParallelContext``). With
``ctx.mesh`` None (``LOCAL_CTX``) it runs on one device; under a mesh the
parameters and activations are DTensors, each layer's weights are
gathered over the data axes where the recipe split them
(``attention.unshard_data``), attention is constrained as the reference's,
the moe layer runs expert-parallel, and ``ctx.feature_shard_decode``
(``tp2d_serve``) keeps a decode step's residual stream split over its
features, as the reference's ``layer_decode`` does.

Rematerialisation follows ``cfg.remat_policy`` over the reference's
regions (``_remat``): a layer of the uniform stack, or ``cfg.layer_group``
of them; a group of gemma3's stack or of the vlm's, and a layer of its
tail. It applies only where a gradient is wanted.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import Params, linear, mlp, mlp_init, rmsnorm, rmsnorm_init
from repro_torch.models.moe import LOCAL_CTX, moe_ffn, moe_ffn_local, moe_init


# the products whose outputs the "minimal" policy keeps: the reference's
# ``checkpoint_dots``
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default]


def _save_dots():
    return create_selective_checkpoint_contexts(_DOTS)


def _requires_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_requires_grad(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_requires_grad(v) for v in tree)
    return isinstance(tree, torch.Tensor) and tree.requires_grad


def _remat(fn: Callable, policy: str) -> Callable:
    """The reference's ``_remat``: ``fn(x, *params)`` recomputed in the
    backward (``"full"``), recomputed but for its products' outputs, which
    are kept (``"minimal"``, the reference's ``checkpoint_dots``), or run as
    it is (``"none"``). The checkpoint is taken only where grad mode is on
    and x or a parameter requires grad: inference runs ``fn`` as it is."""
    if policy == "none":
        return fn
    if policy not in ("minimal", "full"):
        raise ValueError(f"unknown remat policy {policy!r}")
    kw = {"context_fn": _save_dots} if policy == "minimal" else {}

    def run(x, *params):
        if torch.is_grad_enabled() and _requires_grad((x, params)):
            return checkpoint(fn, x, *params, use_reentrant=False, **kw)
        return fn(x, *params)
    return run


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
         n_real: Optional[torch.Tensor] = None, ctx=LOCAL_CTX):
    """The layer's FFN: (out, the MoE's aux loss) for the moe family, (out,
    None) for the MLP. ``n_real``: see ``moe.moe_ffn_local``."""
    if cfg.family == "moe":
        if attn._sharded(ctx):
            return moe_ffn(lp["moe"], cfg, y, ctx, n_real)
        return moe_ffn_local(lp["moe"], cfg, y, n_real)
    return mlp(lp["mlp"], y, cfg.act), None


def layer_fwd(lp: Params, cfg: ModelConfig, x: torch.Tensor, *, kind: str,
              positions: Optional[torch.Tensor] = None, ctx=LOCAL_CTX):
    """Returns (x, (k, v), aux): the layer's keys and values feed the
    cache; aux is the MoE's load-balance loss, None for the MLP."""
    lp = attn.unshard_data(lp, ctx)
    h, kv = attn.self_attention_block(
        lp["attn"], cfg.attn, rmsnorm(lp["ln1"], x, cfg.norm_eps),
        kind=kind, positions=positions, ctx=ctx)
    x = x + h
    f, aux = _ffn(lp, cfg, rmsnorm(lp["ln2"], x, cfg.norm_eps), ctx=ctx)
    return x + f, kv, aux


def layer_decode(lp: Params, cfg: ModelConfig, x, ck, cv, pos, *, kind: str = "causal",
                 ctx=LOCAL_CTX):
    """One token through a layer. Under ``ctx.feature_shard_decode`` the
    residual stream stays split over its features on the data axes
    (``fshard``, the reference's), so that every weight (d@data,
    out@model) contracts against its resident shard; a norm, which reduces
    over the features, reads the stream split over the batch instead."""
    lp = attn.unshard_data(lp, ctx)
    fsd = attn._sharded(ctx) and ctx.feature_shard_decode

    def fshard(u):
        return attn._shard(u, ctx, None, None, ctx.data_axes) if fsd else u

    def norm(p, u):
        if fsd:
            u = attn._shard(u, ctx, ctx.data_axes, None, None)
        return rmsnorm(p, u, cfg.norm_eps)

    h = attn.decode_self_attention(
        lp["attn"], cfg.attn, fshard(norm(lp["ln1"], x)), ck, cv, pos, kind=kind)
    x = x + fshard(h)
    return x + fshard(_ffn(lp, cfg, fshard(norm(lp["ln2"], x)), ctx=ctx)[0])


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


def uniform_stack_fwd(sp: Params, cfg: ModelConfig, x, *, collect_kv: bool = False,
                      ctx=LOCAL_CTX):
    """Returns (x, aux, kvs): aux the MoE's load-balance loss summed over
    the layers (f32, 0 for the dense family), as the reference's scan
    carries it; kvs = (k (L,B,S,KVH,D), v (...)) if collect_kv. A remat
    region is one layer, or ``cfg.layer_group`` layers where that divides
    the stack and the policy is not ``"none"``, as in the reference."""
    kind = _kind_for(cfg)
    g = max(1, cfg.layer_group)
    if not (g > 1 and cfg.n_layers % g == 0 and cfg.remat_policy != "none"):
        g = 1

    def group(x, aux, lps):
        kvs = []
        for lp in lps:
            x, kv, a = layer_fwd(lp, cfg, x, kind=kind, ctx=ctx)
            if a is not None:
                aux = aux + a
            if collect_kv:
                kvs.append(kv)
        return x, aux, kvs

    run = _remat(group, cfg.remat_policy)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers, kvs = unstack(sp), []
    for i in range(0, len(layers), g):
        x, aux, kv = run(x, aux, layers[i:i + g])
        kvs += kv
    if not collect_kv:
        return x, aux, None
    return x, aux, tuple(torch.stack(u) for u in zip(*kvs))


def uniform_stack_extend(sp: Params, cfg: ModelConfig, x, cache_k, cache_v,
                         offsets: torch.Tensor, ctx=LOCAL_CTX):
    """Chunked prefill: run a chunk through the stack, extending the caches
    in place (the engine's path for continuous batching). x (1, C, d): c
    tokens padded to C rows; cache_{k,v}: (L, B_slots, Smax, KVH, D), the
    whole cache; offsets: an int64 tensor ``[slot, pos0, c]`` on the
    cache's device, read there, so that one captured step serves every
    chunk of C rows (the reference traces slot and pos0 the same way). The
    padding's keys and values go to the trash position Smax - 1, and the
    MoE routes only the c real rows, with the capacity of c tokens (the
    reference's extend sees exactly c). Under a mesh (the parameters and
    the cache DTensors) each layer's weights are gathered over the data
    axes where they are split there, the cache is written and read as
    ``attention.extend_self_attention`` says, and the moe layer runs
    expert-parallel on the c real rows: the reference's extend hands
    ``ctx`` to ``moe_ffn`` and nowhere else."""
    positions, rows = attn.chunk_rows(offsets, x.shape[1], cache_k.shape[2])
    for i, lp in enumerate(unstack(sp)):
        lp = attn.unshard_data(lp, ctx)
        x = x + attn.extend_self_attention(
            lp["attn"], cfg.attn, rmsnorm(lp["ln1"], x, cfg.norm_eps),
            cache_k[i], cache_v[i], offsets, positions, rows)
        x = x + _ffn(lp, cfg, rmsnorm(lp["ln2"], x, cfg.norm_eps), offsets[2:], ctx)[0]
    return x


def uniform_stack_decode(sp: Params, cfg: ModelConfig, x, cache_k, cache_v, pos,
                         ctx=LOCAL_CTX):
    for i, lp in enumerate(unstack(sp)):
        x = layer_decode(lp, cfg, x, cache_k[i], cache_v[i], pos, ctx=ctx)
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


def lg_stack_fwd(sp: Params, cfg: ModelConfig, x, *, collect_kv: bool = False,
                 ctx=LOCAL_CTX):
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

    def run(x, aux, lp, kind, dst):
        x, kv, f = layer_fwd(lp, cfg, x, kind=kind, ctx=ctx)
        if f is not None:
            aux = aux + f
        if collect_kv:
            for d, u in zip(dst, kv):
                d.copy_(to_ring(u, W) if kind == "local" else u)
        return x, aux

    def group(x, aux, lps, gp, i):
        for j, lp in enumerate(unstack(lps)):
            x, aux = run(x, aux, lp, "local", collect_kv and [t[i, j] for t in local_kv])
        return run(x, aux, gp, "causal", collect_kv and [t[i] for t in global_kv])

    def tail_layer(x, aux, lp, j):
        return run(x, aux, lp, "local", collect_kv and [t[j] for t in tail_kv])

    group, tail_layer = (_remat(f, cfg.remat_policy) for f in (group, tail_layer))
    for i, (lps, gp) in enumerate(zip(unstack(sp["locals"]), unstack(sp["globals"]))):
        x, aux = group(x, aux, lps, gp, i)
    if sp["tail"] is not None:
        for j, lp in enumerate(unstack(sp["tail"])):
            x, aux = tail_layer(x, aux, lp, j)
    return x, aux, ((local_kv, global_kv, tail_kv) if collect_kv else None)


def lg_stack_decode(sp: Params, cfg: ModelConfig, x, cache: Cache, pos, ctx=LOCAL_CTX):
    """One token through the stack; the local rings (``local_{k,v}`` (g, r,
    B, W, ...), ``tail_{k,v}``) and the global caches (``global_{k,v}`` (g,
    B, Smax, ...)) are updated in place."""
    for i, (lps, gp) in enumerate(zip(unstack(sp["locals"]), unstack(sp["globals"]))):
        for j, lp in enumerate(unstack(lps)):
            x = layer_decode(lp, cfg, x, cache["local_k"][i, j], cache["local_v"][i, j], pos,
                             kind="local", ctx=ctx)
        x = layer_decode(gp, cfg, x, cache["global_k"][i], cache["global_v"][i], pos,
                         kind="causal", ctx=ctx)
    if sp["tail"] is not None:
        for j, lp in enumerate(unstack(sp["tail"])):
            x = layer_decode(lp, cfg, x, cache["tail_k"][j], cache["tail_v"][j], pos,
                             kind="local", ctx=ctx)
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


def _cross_layer_fwd(cp: Params, cfg: ModelConfig, x, vision, kv=None, ctx=LOCAL_CTX):
    cp = attn.unshard_data(cp, ctx)
    x = x + attn.cross_attention_block(cp["xattn"], cfg.attn,
                                       rmsnorm(cp["ln"], x, cfg.norm_eps), vision, kv, ctx)
    return x + mlp(cp["mlp"], rmsnorm(cp["ln2"], x, cfg.norm_eps), cfg.act)


def vlm_stack_fwd(sp: Params, cfg: ModelConfig, x, vision, *, collect_kv: bool = False,
                  ctx=LOCAL_CTX):
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
        cross = vlm_precompute_cross_kv(sp, cfg, vision, ctx)

    def group(x, sps, cp, vision, i):
        for j, lp in enumerate(unstack(sps)):
            x, kv, _ = layer_fwd(lp, cfg, x, kind="causal", ctx=ctx)
            if collect_kv:
                for d, u in zip(kvs, kv):
                    d[i, j].copy_(u)
        return _cross_layer_fwd(cp, cfg, x, vision,
                                (cross[0][i], cross[1][i]) if collect_kv else None, ctx)

    group = _remat(group, cfg.remat_policy)
    for i, (sps, cp) in enumerate(zip(unstack(sp["selfs"]), unstack(sp["crosses"]))):
        x = group(x, sps, cp, vision, i)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux, ((kvs, cross) if collect_kv else None)


def vlm_precompute_cross_kv(sp: Params, cfg: ModelConfig, vision, ctx=LOCAL_CTX):
    """The vision tokens (B, T, d_vision) through every cross layer's k and
    v projections once: (k, v), each (g, B, T, KVH, D)."""
    a = cfg.attn
    B, T, _ = vision.shape
    g = vlm_split(cfg)[0]
    kvs = tuple(vision.new_empty((g, B, T, a.n_kv_heads, a.head_dim)) for _ in "kv")
    for i, cp in enumerate(unstack(sp["crosses"])):
        xp = attn.unshard_data(cp["xattn"], ctx)
        for d, w in zip(kvs, (xp["wk"], xp["wv"])):
            d[i] = linear(vision, w).reshape(B, T, a.n_kv_heads, a.head_dim)
    return kvs


def _cross_layer_decode(cp: Params, cfg: ModelConfig, x, ck, cv, ctx=LOCAL_CTX):
    """One token's cross layer over the cached vision keys and values (B,
    T, KVH, D): the query without RoPE (and without qk-norm, as in the
    reference's decode), every key valid, on the flash-decode kernel."""
    cp = attn.unshard_data(cp, ctx)
    a, xp = cfg.attn, cp["xattn"]
    B = x.shape[0]
    q = linear(rmsnorm(cp["ln"], x, cfg.norm_eps), xp["wq"]).reshape(B, 1, a.n_heads, a.head_dim)
    kv_len = torch.full((B,), ck.shape[1], dtype=torch.int64, device=x.device)
    o = linear(attn.decode_attention(q, ck, cv, kv_len).reshape(B, 1, -1), xp["wo"])
    x = x + torch.tanh(xp["gate"]).to(o.dtype) * o
    return x + mlp(cp["mlp"], rmsnorm(cp["ln2"], x, cfg.norm_eps), cfg.act)


def vlm_stack_decode(sp: Params, cfg: ModelConfig, x, cache: Cache, pos, ctx=LOCAL_CTX):
    """One token through the stack: the self layers' caches ``k``, ``v``
    (g, n_self, B, Smax, KVH, D) updated in place, the cross layers over
    ``cross_k``, ``cross_v`` (g, B, T_vision, KVH, D)."""
    for i, (sps, cp) in enumerate(zip(unstack(sp["selfs"]), unstack(sp["crosses"]))):
        for j, lp in enumerate(unstack(sps)):
            x = layer_decode(lp, cfg, x, cache["k"][i, j], cache["v"][i, j], pos, ctx=ctx)
        x = _cross_layer_decode(cp, cfg, x, cache["cross_k"][i], cache["cross_v"][i], ctx)
    return x
