"""Model facade for every family: dense and moe decoders (global
attention, or gemma3's local:global stack), the SSM family (Mamba-1 and
Mamba-2), the hybrid family (zamba2), the vlm family (self layers grouped
with tanh-gated cross attention over vision tokens) and the audio encoder.

  m = build_model(cfg)                      # device="cuda" unless told
  params = m.init(generator)
  logits = m.forward(params, batch)
  logits, cache = m.prefill(params, batch, max_len)
  logits, cache = m.decode_step(params, tokens, cache, pos)   # cache in place
  cache = m.init_cache(batch_size, max_len)

Batches: {"tokens": (B, S) integer tensor}; the vlm family adds
{"vision": (B, n_vision_tokens, d_vision)}, the precomputed patch
embeddings; the audio family takes {"frames": (B, S, d_model)}, the
precomputed frame embeddings, in place of tokens (no lookup on the way in).
Both are cast to the parameters' type. ``forward`` returns the logits (the
moe family's load-balance loss, which the reference's ``forward`` also
returns, is the stack's second result). The audio family is an encoder:
``prefill``, ``decode_step`` and ``init_cache`` raise ValueError, as the
reference's do.

A local:global cache holds ``local_{k,v}`` (g, r, B, W, KVH, D) and, for a
tail of local layers, ``tail_{k,v}`` (tail, B, W, KVH, D): rings of W =
``min(local_window, max_len)`` rows from ``init_cache``, of
``local_window`` rows from ``prefill`` (the reference's shapes); and
``global_{k,v}`` (g, B, max_len, KVH, D). A vlm cache holds the self
layers' ``k``, ``v`` (g, n_self, B, max_len, KVH, D) and the vision
tokens' keys and values of every cross layer, ``cross_k``, ``cross_v`` (g,
B, n_vision_tokens, KVH, D), projected once at prefill.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import hybrid as hyb
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (_dtype, embed, embed_init, rmsnorm,
                                       rmsnorm_init, unembed)

Batch = Dict[str, torch.Tensor]

KV_DTYPE = torch.bfloat16        # init_cache is bf16 whatever the parameters are


class Model(NamedTuple):
    cfg: ModelConfig
    device: torch.device
    init: Callable               # (generator) -> params
    forward: Callable            # (params, batch) -> logits
    prefill: Callable            # (params, batch, max_len) -> (logits, cache)
    decode_step: Callable        # (params, tokens, cache, pos) -> (logits, cache)
    init_cache: Callable         # (batch_size, max_len) -> cache


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. ``cuda`` needs a card: nothing
    falls back to the CPU by itself."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' was asked for and no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    return device


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    device = resolve_device(device)
    family = cfg.family
    if family not in ("ssm", "hybrid", "dense", "moe", "vlm", "audio"):
        raise ValueError(f"{cfg.name}: unknown family {family!r}")
    dtype = _dtype(cfg.param_dtype)
    a = cfg.attn
    lg = family in ("dense", "moe") and a.pattern == "local_global"

    def init(gen: torch.Generator):
        if gen.device.type != device.type:
            raise ValueError(f"generator on {gen.device}, model on {device}")
        stack = (tfm.lg_stack_init if lg else
                 {"ssm": hyb.ssm_stack_init, "hybrid": hyb.hybrid_stack_init,
                  "dense": tfm.uniform_stack_init, "moe": tfm.uniform_stack_init,
                  "audio": tfm.uniform_stack_init,
                  "vlm": tfm.vlm_stack_init}[family])(gen, cfg, dtype)
        return {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model,
                                    cfg.tie_embeddings, dtype),
                "final_ln": rmsnorm_init(cfg.d_model, device),
                "stack": stack}

    def _embed_in(p, batch):
        if family == "audio":
            return batch["frames"].to(dtype)
        return embed(p["embed"], batch["tokens"], scale_by_dim=cfg.embed_scale)

    def _vision(batch):
        return batch["vision"].to(dtype)

    def _encoder_refuses():
        if cfg.is_encoder:
            raise ValueError("encoder-only model has no prefill/decode")

    def forward(p, batch: Batch):
        x = _embed_in(p, batch)
        if family == "ssm":
            x = hyb.ssm_stack_fwd(p["stack"], cfg, x)
        elif family == "hybrid":
            x = hyb.hybrid_stack_fwd(p["stack"], cfg, x)
        elif family == "vlm":
            x, _, _ = tfm.vlm_stack_fwd(p["stack"], cfg, x, _vision(batch))
        elif lg:
            x, _, _ = tfm.lg_stack_fwd(p["stack"], cfg, x)
        else:
            x, _, _ = tfm.uniform_stack_fwd(p["stack"], cfg, x)
        return unembed(p["embed"], rmsnorm(p["final_ln"], x, cfg.norm_eps))

    def _states(lead: tuple, batch_size: int):
        """Zeroed SSM states with leading dims ``lead``: fixed-size, so
        max_len does not enter."""
        one = hyb.ssm_init_state(cfg, batch_size, "meta")
        return {k: torch.zeros(lead + tuple(v.shape), dtype=v.dtype, device=device)
                for k, v in one.items()}

    def _hybrid_states(batch_size: int):
        g, tail = hyb.hybrid_split(cfg)
        c = {"ssm": _states((g, cfg.hybrid_attn_every), batch_size)}
        if tail:
            c["tail"] = _states((tail,), batch_size)
        return c

    def _zeros(*shape):
        return torch.zeros(shape, dtype=KV_DTYPE, device=device)

    def init_cache(batch_size: int, max_len: int):
        if cfg.is_encoder:
            raise ValueError(f"{family} has no decode cache (encoder-only?)")
        if family == "vlm":
            g, ns = tfm.vlm_split(cfg)
            KVH, D = a.n_kv_heads, a.head_dim
            return {"k": _zeros(g, ns, batch_size, max_len, KVH, D),
                    "v": _zeros(g, ns, batch_size, max_len, KVH, D),
                    "cross_k": _zeros(g, batch_size, cfg.n_vision_tokens, KVH, D),
                    "cross_v": _zeros(g, batch_size, cfg.n_vision_tokens, KVH, D)}
        if family == "ssm":
            return _states((cfg.n_layers,), batch_size)
        if lg:
            g, tail = tfm.lg_split(cfg)
            W, KVH, D = min(a.local_window, max_len), a.n_kv_heads, a.head_dim
            c = {"local_k": _zeros(g, a.local_ratio, batch_size, W, KVH, D),
                 "local_v": _zeros(g, a.local_ratio, batch_size, W, KVH, D),
                 "global_k": _zeros(g, batch_size, max_len, KVH, D),
                 "global_v": _zeros(g, batch_size, max_len, KVH, D)}
            if tail:
                c["tail_k"] = _zeros(tail, batch_size, W, KVH, D)
                c["tail_v"] = _zeros(tail, batch_size, W, KVH, D)
            return c
        n = hyb.hybrid_split(cfg)[0] if family == "hybrid" else cfg.n_layers
        shape = (n, batch_size, max_len, a.n_kv_heads, a.head_dim)
        k, v = (_zeros(*shape) for _ in "kv")
        if family == "hybrid":
            return {**_hybrid_states(batch_size), "attn_k": k, "attn_v": v}
        return {"k": k, "v": v}

    def _pad_to(kv, max_len: int):
        """(..., B, S, KVH, D) keys or values padded with zeros along S up to
        max_len: as in the reference, the prefilled cache keeps the keys'
        own type (bf16 for bf16 parameters)."""
        return F.pad(kv, (0, 0, 0, 0, 0, max(max_len - kv.shape[-3], 0)))

    def prefill(p, batch: Batch, max_len: int):
        _encoder_refuses()
        x = _embed_in(p, batch)
        B = x.shape[0]
        if family == "ssm":
            cache = init_cache(B, max_len)
            x = hyb.ssm_stack_prefill(p["stack"], cfg, x, cache)
        elif family == "hybrid":
            cache = _hybrid_states(B)
            x, (k, v) = hyb.hybrid_stack_prefill(p["stack"], cfg, x, cache["ssm"],
                                                 cache.get("tail"))
            cache.update(attn_k=_pad_to(k, max_len), attn_v=_pad_to(v, max_len))
        elif family == "vlm":
            vision = _vision(batch)
            x, _, ((k, v), (xk, xv)) = tfm.vlm_stack_fwd(p["stack"], cfg, x, vision,
                                                        collect_kv=True)
            cache = {"k": _pad_to(k, max_len), "v": _pad_to(v, max_len),
                     "cross_k": xk, "cross_v": xv}
        elif lg:
            x, _, (lkv, (gk, gv), tkv) = tfm.lg_stack_fwd(p["stack"], cfg, x, collect_kv=True)
            cache = {"local_k": lkv[0], "local_v": lkv[1],
                     "global_k": _pad_to(gk, max_len), "global_v": _pad_to(gv, max_len)}
            if tkv is not None:
                cache["tail_k"], cache["tail_v"] = tkv
        else:
            x, _, (k, v) = tfm.uniform_stack_fwd(p["stack"], cfg, x, collect_kv=True)
            cache = {"k": _pad_to(k, max_len), "v": _pad_to(v, max_len)}
        x = rmsnorm(p["final_ln"], x[:, -1:], cfg.norm_eps)
        return unembed(p["embed"], x), cache

    def decode_step(p, tokens, cache, pos):
        """tokens (B,1) integers; pos: int, () or (B,) absolute position
        (the SSM family's state carries its own position and ignores it;
        the hybrid family's shared block takes it for RoPE and the cache
        writes). The cache is updated in place and returned."""
        _encoder_refuses()
        x = embed(p["embed"], tokens, scale_by_dim=cfg.embed_scale)
        if family == "ssm":
            x = hyb.ssm_stack_decode(p["stack"], cfg, x, cache)
        elif family == "hybrid":
            x = hyb.hybrid_stack_decode(p["stack"], cfg, x, cache["ssm"], cache["attn_k"],
                                        cache["attn_v"], cache.get("tail"), pos)
        elif family == "vlm":
            x = tfm.vlm_stack_decode(p["stack"], cfg, x, cache, pos)
        elif lg:
            x = tfm.lg_stack_decode(p["stack"], cfg, x, cache, pos)
        else:
            x = tfm.uniform_stack_decode(p["stack"], cfg, x, cache["k"], cache["v"], pos)
        x = rmsnorm(p["final_ln"], x, cfg.norm_eps)
        return unembed(p["embed"], x), cache

    return Model(cfg, device, init, forward, prefill, decode_step, init_cache)
