"""Model facade for the dense / global-attention family and the Mamba-1
SSM family.

  m = build_model(cfg)                      # device="cuda" unless told
  params = m.init(generator)
  logits = m.forward(params, batch)
  logits, cache = m.prefill(params, batch, max_len)
  logits, cache = m.decode_step(params, tokens, cache, pos)   # cache in place
  cache = m.init_cache(batch_size, max_len)

Batches: {"tokens": (B, S) integer tensor}. The other families of the
configuration registry are not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import hybrid as hyb
from repro_torch.models import ssm
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (_dtype, embed, embed_init, rmsnorm,
                                       rmsnorm_init, unembed)

Batch = Dict[str, torch.Tensor]

KV_DTYPE = torch.bfloat16        # init_cache is bf16 whatever the parameters are

_ROADMAP_ITEM = {"ssm": "A6b (Mamba-2 SSD and the hybrid stack)",
                 "hybrid": "A6b (Mamba-2 SSD and the hybrid stack)",
                 "moe": "A7 (remaining model families)",
                 "vlm": "A7 (remaining model families)",
                 "audio": "A7 (remaining model families)"}


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
    is_ssm = cfg.family == "ssm" and cfg.ssm.variant == "mamba1"
    if not is_ssm and (cfg.family != "dense" or cfg.attn.pattern != "global"):
        item = ("A7 (remaining model families)" if cfg.family == "dense"
                else _ROADMAP_ITEM.get(cfg.family, "A7"))
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} with attention pattern "
            f"{cfg.attn.pattern!r} is not ported yet (ROADMAP.md item {item})")
    dtype = _dtype(cfg.param_dtype)
    a = cfg.attn

    def init(gen: torch.Generator):
        if gen.device.type != device.type:
            raise ValueError(f"generator on {gen.device}, model on {device}")
        stack = (hyb.ssm_stack_init(gen, cfg, dtype) if is_ssm
                 else tfm.uniform_stack_init(gen, cfg, dtype))
        return {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model,
                                    cfg.tie_embeddings, dtype),
                "final_ln": rmsnorm_init(cfg.d_model, device),
                "stack": stack}

    def _embed_in(p, batch):
        return embed(p["embed"], batch["tokens"], scale_by_dim=cfg.embed_scale)

    def forward(p, batch: Batch):
        if is_ssm:
            x = hyb.ssm_stack_fwd(p["stack"], cfg, _embed_in(p, batch))
        else:
            x, _ = tfm.uniform_stack_fwd(p["stack"], cfg, _embed_in(p, batch))
        return unembed(p["embed"], rmsnorm(p["final_ln"], x, cfg.norm_eps))

    def init_cache(batch_size: int, max_len: int):
        if is_ssm:      # fixed-size states: max_len does not enter
            s, L = cfg.ssm, cfg.n_layers
            return {"conv": torch.zeros((L, batch_size, s.d_conv - 1, cfg.d_inner),
                                        dtype=ssm.CONV_DTYPE, device=device),
                    "h": torch.zeros((L, batch_size, cfg.d_inner, s.d_state),
                                     dtype=torch.float32, device=device)}
        shape = (cfg.n_layers, batch_size, max_len, a.n_kv_heads, a.head_dim)
        return {"k": torch.zeros(shape, dtype=KV_DTYPE, device=device),
                "v": torch.zeros(shape, dtype=KV_DTYPE, device=device)}

    def prefill(p, batch: Batch, max_len: int):
        if is_ssm:
            tokens = batch["tokens"]
            cache = init_cache(tokens.shape[0], max_len)
            x = hyb.ssm_stack_prefill(p["stack"], cfg, _embed_in(p, batch), cache)
        else:
            x, (k, v) = tfm.uniform_stack_fwd(p["stack"], cfg, _embed_in(p, batch),
                                              collect_kv=True)
            # as in the reference, the prefilled cache keeps the keys' own type
            # (bf16 for bf16 parameters), padded with zeros up to max_len
            pad = (0, 0, 0, 0, 0, max(max_len - k.shape[2], 0))
            cache = {"k": F.pad(k, pad), "v": F.pad(v, pad)}
        x = rmsnorm(p["final_ln"], x[:, -1:], cfg.norm_eps)
        return unembed(p["embed"], x), cache

    def decode_step(p, tokens, cache, pos):
        """tokens (B,1) integers; pos: int, () or (B,) absolute position
        (the SSM family's state carries its own position and ignores it).
        The cache is updated in place and returned."""
        x = embed(p["embed"], tokens, scale_by_dim=cfg.embed_scale)
        if is_ssm:
            x = hyb.ssm_stack_decode(p["stack"], cfg, x, cache)
        else:
            x = tfm.uniform_stack_decode(p["stack"], cfg, x, cache["k"], cache["v"], pos)
        x = rmsnorm(p["final_ln"], x, cfg.norm_eps)
        return unembed(p["embed"], x), cache

    return Model(cfg, device, init, forward, prefill, decode_step, init_cache)
