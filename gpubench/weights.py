"""Weights drawn from the seed on the device, in the nested layout that
``repro_torch.serve.engine.Engine(params=)`` takes and the reference reads.

One ``torch.Generator`` on the device, one normal draw a leaf over all its
layers at once, in the type the model is served in: bf16 products (scaled
by 1 / sqrt(fan-in)), f32 router and norm scales (1 + 0.1 N(0, 1), so that
a norm's scale is not all ones and a check sees it applied).
"""
from __future__ import annotations

from typing import Dict

import torch

BF16 = torch.bfloat16
F32 = torch.float32


def model_config(config: Dict):
    """The program's ``ModelConfig`` of a configuration file: the registry's
    entry with the file's ``overrides`` (a nested group, such as ``attn``,
    as a dict of its changed fields)."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    cfg = get_config(config["registry"])
    kw = {k: dataclasses.replace(getattr(cfg, k), **v) if isinstance(v, dict) else v
          for k, v in config.get("overrides", {}).items()}
    return cfg.with_overrides(**kw) if kw else cfg


def shape(cfg) -> Dict:
    """The numbers the reference and the counts read, from a ModelConfig."""
    a = cfg.attn
    out = {"family": cfg.family, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size, "n_heads": a.n_heads,
           "n_kv_heads": a.n_kv_heads, "head_dim": a.head_dim, "qk_norm": a.qk_norm,
           "rope_theta": a.rope_theta, "norm_eps": cfg.norm_eps,
           "tie_embeddings": cfg.tie_embeddings}
    if cfg.family == "moe":
        m = cfg.moe
        out["moe"] = {"n_experts": m.n_experts, "top_k": m.top_k,
                      "d_ff_expert": m.d_ff_expert, "capacity_factor": m.capacity_factor}
    return out


def draw(s: Dict, seed: int, device) -> Dict:
    """The weights of shape ``s`` (``shape``) from ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    L, d, V = s["n_layers"], s["d_model"], s["vocab_size"]
    H, KVH, D = s["n_heads"], s["n_kv_heads"], s["head_dim"]

    def normal(shape, scale, dtype=BF16):
        x = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        return x.mul_(scale)

    def norm(*shape):
        return normal(shape, 0.1, F32).add_(1.0)

    attn = {"wq": normal((L, d, H * D), d ** -0.5),
            "wk": normal((L, d, KVH * D), d ** -0.5),
            "wv": normal((L, d, KVH * D), d ** -0.5),
            "wo": normal((L, H * D, d), (H * D) ** -0.5)}
    if s["qk_norm"]:
        attn["q_norm"], attn["k_norm"] = norm(L, D), norm(L, D)
    stack = {"ln1": {"scale": norm(L, d)}, "ln2": {"scale": norm(L, d)}, "attn": attn}
    if s["family"] == "moe":
        E, f = s["moe"]["n_experts"], s["moe"]["d_ff_expert"]
        stack["moe"] = {"router": normal((L, d, E), d ** -0.5, F32),
                        "w_gate": normal((L, E, d, f), d ** -0.5),
                        "w_up": normal((L, E, d, f), d ** -0.5),
                        "w_down": normal((L, E, f, d), f ** -0.5)}
    else:
        f = s["d_ff"]
        stack["mlp"] = {"w_gate": normal((L, d, f), d ** -0.5),
                        "w_up": normal((L, d, f), d ** -0.5),
                        "w_down": normal((L, f, d), f ** -0.5)}
    embed = {"embedding": normal((V, d), d ** -0.5)}
    if not s["tie_embeddings"]:
        embed["unembed"] = normal((d, V), d ** -0.5)
    return {"embed": embed, "final_ln": {"scale": norm(d)}, "stack": stack}


def n_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(n_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()
