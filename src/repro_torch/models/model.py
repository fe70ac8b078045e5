"""Model facade for the dense and moe families with global attention, the
SSM family (Mamba-1 and Mamba-2) and the hybrid family (zamba2).

  m = build_model(cfg)                      # device="cuda" unless told
  params = m.init(generator)
  logits = m.forward(params, batch)
  logits, cache = m.prefill(params, batch, max_len)
  logits, cache = m.decode_step(params, tokens, cache, pos)   # cache in place
  cache = m.init_cache(batch_size, max_len)

Batches: {"tokens": (B, S) integer tensor}. ``forward`` returns the logits
(the moe family's load-balance loss, which the reference's ``forward``
also returns, is ``transformer.uniform_stack_fwd``'s second result). The
vlm and audio families and local/global attention are not ported yet and
raise ``NotImplementedError`` (ROADMAP A7).
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
    if family not in ("ssm", "hybrid") and (family not in ("dense", "moe")
                                            or cfg.attn.pattern != "global"):
        raise NotImplementedError(
            f"{cfg.name}: family {family!r} with attention pattern "
            f"{cfg.attn.pattern!r} is not ported yet (ROADMAP.md item A7 "
            "(remaining model families))")
    dtype = _dtype(cfg.param_dtype)
    a = cfg.attn

    def init(gen: torch.Generator):
        if gen.device.type != device.type:
            raise ValueError(f"generator on {gen.device}, model on {device}")
        stack = {"ssm": hyb.ssm_stack_init, "hybrid": hyb.hybrid_stack_init,
                 "dense": tfm.uniform_stack_init,
                 "moe": tfm.uniform_stack_init}[family](gen, cfg, dtype)
        return {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model,
                                    cfg.tie_embeddings, dtype),
                "final_ln": rmsnorm_init(cfg.d_model, device),
                "stack": stack}

    def _embed_in(p, batch):
        return embed(p["embed"], batch["tokens"], scale_by_dim=cfg.embed_scale)

    def forward(p, batch: Batch):
        x = _embed_in(p, batch)
        if family == "ssm":
            x = hyb.ssm_stack_fwd(p["stack"], cfg, x)
        elif family == "hybrid":
            x = hyb.hybrid_stack_fwd(p["stack"], cfg, x)
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

    def init_cache(batch_size: int, max_len: int):
        if family == "ssm":
            return _states((cfg.n_layers,), batch_size)
        n = hyb.hybrid_split(cfg)[0] if family == "hybrid" else cfg.n_layers
        shape = (n, batch_size, max_len, a.n_kv_heads, a.head_dim)
        k, v = (torch.zeros(shape, dtype=KV_DTYPE, device=device) for _ in "kv")
        if family == "hybrid":
            return {**_hybrid_states(batch_size), "attn_k": k, "attn_v": v}
        return {"k": k, "v": v}

    def _pad_to(kv, max_len: int):
        """(n, B, S, KVH, D) keys or values padded with zeros up to max_len:
        as in the reference, the prefilled cache keeps the keys' own type
        (bf16 for bf16 parameters)."""
        return F.pad(kv, (0, 0, 0, 0, 0, max(max_len - kv.shape[2], 0)))

    def prefill(p, batch: Batch, max_len: int):
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
        x = embed(p["embed"], tokens, scale_by_dim=cfg.embed_scale)
        if family == "ssm":
            x = hyb.ssm_stack_decode(p["stack"], cfg, x, cache)
        elif family == "hybrid":
            x = hyb.hybrid_stack_decode(p["stack"], cfg, x, cache["ssm"], cache["attn_k"],
                                        cache["attn_v"], cache.get("tail"), pos)
        else:
            x = tfm.uniform_stack_decode(p["stack"], cfg, x, cache["k"], cache["v"], pos)
        x = rmsnorm(p["final_ln"], x, cfg.norm_eps)
        return unembed(p["embed"], x), cache

    return Model(cfg, device, init, forward, prefill, decode_step, init_cache)
