"""Decoder stack for the dense and moe families: the reference's scan over
stacked ``(L, ...)`` layer parameters is a Python loop over the same
stacked tensors, so the parameter tree keeps the reference's shape. A moe
layer has ``moe`` (``models/moe.py``, the local path) where a dense layer
has ``mlp``. Caches are updated in place. No rematerialisation and no
sharding constraints: one device, inference only.
"""
from __future__ import annotations

from typing import Optional

import torch

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


def layer_decode(lp: Params, cfg: ModelConfig, x, ck, cv, pos):
    h = attn.decode_self_attention(
        lp["attn"], cfg.attn, rmsnorm(lp["ln1"], x, cfg.norm_eps), ck, cv, pos)
    x = x + h
    return x + _ffn(lp, cfg, rmsnorm(lp["ln2"], x, cfg.norm_eps))[0]


# ===================================================================== #
#  Uniform stack (dense, moe)                                            #
# ===================================================================== #
def stack_init(draw, n: int) -> Params:
    """n trees drawn one after another by ``draw()``, stacked leaf by leaf
    into (n, ...) tensors. Each is copied into its place as it is drawn, so
    the stack and one tree are all that is ever held: a stack of 57 GB
    (moonshot-v1-16b-a3b) would not fit on an 80 GB card twice."""
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
