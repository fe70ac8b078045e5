"""Decoder stack for the dense family: the reference's scan over stacked
``(L, ...)`` layer parameters is a Python loop over the same stacked
tensors, so the parameter tree keeps the reference's shape. Caches are
updated in place. No rematerialisation and no sharding constraints: one
device, inference only.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import Params, mlp, mlp_init, rmsnorm, rmsnorm_init


def unstack(sp: Params) -> list:
    """Stacked ``(L, ...)`` parameters as a list of L per-layer trees of
    views (one ``unbind`` per leaf, not one indexing per leaf and layer)."""
    if isinstance(sp, dict):
        parts = {k: unstack(v) for k, v in sp.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(sp.unbind(0))


# ===================================================================== #
#  One decoder layer (pre-norm attn + pre-norm FFN)                      #
# ===================================================================== #
def layer_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16) -> Params:
    return {"ln1": rmsnorm_init(cfg.d_model, gen.device),
            "ln2": rmsnorm_init(cfg.d_model, gen.device),
            "attn": attn.attn_init(gen, cfg.attn, cfg.d_model, dtype=dtype),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype)}


def layer_fwd(lp: Params, cfg: ModelConfig, x: torch.Tensor, *, kind: str,
              positions: Optional[torch.Tensor] = None):
    """Returns (x, (k, v)) — the layer's keys and values feed the cache."""
    h, kv = attn.self_attention_block(
        lp["attn"], cfg.attn, rmsnorm(lp["ln1"], x, cfg.norm_eps),
        kind=kind, positions=positions)
    x = x + h
    x = x + mlp(lp["mlp"], rmsnorm(lp["ln2"], x, cfg.norm_eps), cfg.act)
    return x, kv


def layer_decode(lp: Params, cfg: ModelConfig, x, ck, cv, pos):
    h = attn.decode_self_attention(
        lp["attn"], cfg.attn, rmsnorm(lp["ln1"], x, cfg.norm_eps), ck, cv, pos)
    x = x + h
    return x + mlp(lp["mlp"], rmsnorm(lp["ln2"], x, cfg.norm_eps), cfg.act)


# ===================================================================== #
#  Uniform stack (dense)                                                 #
# ===================================================================== #
def _stack_trees(trees):
    """Stack a list of equal nested dicts leaf by leaf into (L, ...) tensors."""
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def uniform_stack_init(gen: torch.Generator, cfg: ModelConfig,
                       dtype=torch.bfloat16) -> Params:
    """Stacked (L, ...) parameters, the shape of the reference's tree."""
    return _stack_trees([layer_init(gen, cfg, dtype)
                         for _ in range(cfg.n_layers)])


def _kind_for(cfg: ModelConfig) -> str:
    return "bidirectional" if cfg.is_encoder else "causal"


def uniform_stack_fwd(sp: Params, cfg: ModelConfig, x, *, collect_kv: bool = False):
    """Returns (x, kvs); kvs = (k (L,B,S,KVH,D), v (...)) if collect_kv."""
    kind = _kind_for(cfg)
    ks, vs = [], []
    for lp in unstack(sp):
        x, (k, v) = layer_fwd(lp, cfg, x, kind=kind)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    return x, ((torch.stack(ks), torch.stack(vs)) if collect_kv else None)


def uniform_stack_extend(sp: Params, cfg: ModelConfig, x, cache_k, cache_v,
                         offsets: torch.Tensor):
    """Chunked prefill: run a chunk through the stack, extending the caches
    in place (the engine's path for continuous batching). x (1, C, d): c
    tokens padded to C rows; cache_{k,v}: (L, B_slots, Smax, KVH, D), the
    whole cache; offsets: an int64 tensor ``[slot, pos0, c]`` on the
    cache's device, read there, so that one captured step serves every
    chunk of C rows (the reference traces slot and pos0 the same way). The
    padding's keys and values go to the trash position Smax - 1."""
    positions, rows = attn.chunk_rows(offsets, x.shape[1], cache_k.shape[2])
    for i, lp in enumerate(unstack(sp)):
        x = x + attn.extend_self_attention(
            lp["attn"], cfg.attn, rmsnorm(lp["ln1"], x, cfg.norm_eps),
            cache_k[i], cache_v[i], offsets, positions, rows)
        x = x + mlp(lp["mlp"], rmsnorm(lp["ln2"], x, cfg.norm_eps), cfg.act)
    return x


def uniform_stack_decode(sp: Params, cfg: ModelConfig, x, cache_k, cache_v, pos):
    for i, lp in enumerate(unstack(sp)):
        x = layer_decode(lp, cfg, x, cache_k[i], cache_v[i], pos)
    return x
