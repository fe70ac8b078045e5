"""SSM stacks (falcon-mamba) and hybrid stacks (zamba2: a Mamba-2 backbone
with one SHARED transformer block applied after every k SSM layers): the
twin of ``src/repro/models/hybrid.py``.

The reference's ``lax.scan`` over stacked ``(L, ...)`` layer parameters is a
Python loop over the same stacked tensors (``transformer.unstack``), so the
parameter tree keeps the reference's shape; the hybrid stack's SSM layers
are a stack of stacks ``(g, k, ...)``, unstacked twice. Per-layer states
are stacked tensors too, written in place by prefill and by every decode
step. As in the reference, the shared block reads the running hidden state
(zamba2 concatenates the original embedding; the reference keeps a
single-width residual). The reference's ``_mamba2_fwd_with_state`` is
``ssm.mamba2_forward_with_state``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm
from repro_torch.models.attention import unshard_data
from repro_torch.models.moe import LOCAL_CTX
from repro_torch.models.layers import Params, _summed, linear, rmsnorm, rmsnorm_init
from repro_torch.models.transformer import (_remat, layer_decode, layer_fwd, layer_init,
                                           stack_init, unstack)

Cache = Dict[str, torch.Tensor]


# --------------------------------------------------------------------- #
#  One SSM residual layer                                                #
# --------------------------------------------------------------------- #
def _mamba1(cfg: ModelConfig) -> bool:
    return cfg.ssm.variant == "mamba1"


def ssm_layer_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16) -> Params:
    init = ssm.mamba1_init if _mamba1(cfg) else ssm.mamba2_init
    return {"ln": rmsnorm_init(cfg.d_model, gen.device), "mixer": init(gen, cfg, dtype)}


def ssm_layer_fwd(lp: Params, cfg: ModelConfig, x: torch.Tensor, ctx=LOCAL_CTX) -> torch.Tensor:
    lp = unshard_data(lp, ctx)
    fwd = ssm.mamba1_forward if _mamba1(cfg) else ssm.mamba2_forward
    return x + fwd(lp["mixer"], cfg, rmsnorm(lp["ln"], x, cfg.norm_eps), ctx)


def ssm_layer_step(lp: Params, cfg: ModelConfig, x, state, ctx=LOCAL_CTX):
    lp = unshard_data(lp, ctx)
    step = ssm.mamba1_step if _mamba1(cfg) else ssm.mamba2_step
    out, state = step(lp["mixer"], cfg, rmsnorm(lp["ln"], x, cfg.norm_eps), state, ctx)
    return x + out, state


def ssm_init_state(cfg: ModelConfig, batch: int, device):
    init = ssm.mamba1_init_state if _mamba1(cfg) else ssm.mamba2_init_state
    return init(cfg, batch, device)


def ssm_layer_prefill(lp: Params, cfg: ModelConfig, x, state: Cache, ctx=LOCAL_CTX):
    """The layer over the prompt, writing its final SSM state and the last
    ``d_conv - 1`` pre-conv inputs into ``state`` (views of the cache) in
    place. Returns x."""
    mp = unshard_data(lp, ctx)["mixer"]
    u = rmsnorm(lp["ln"], x, cfg.norm_eps)
    if _mamba1(cfg):
        xx, z, dt, A, B, C = ssm._mamba1_inputs(mp, cfg, u)
        y, _ = ssm.mamba1_scan(xx, dt, A, B, C, out_state=state["h"], ctx=ctx)
        out = ssm._mamba1_out(mp, y, xx, z, u.dtype)
    else:
        out, hT = ssm.mamba2_forward_with_state(mp, cfg, u, ctx)
        state["h"].copy_(hT)
    for name, tail in _conv_tail(cfg, u, mp).items():
        state[name].copy_(tail)
    return x + out


def _conv_tail(cfg: ModelConfig, u: torch.Tensor, mp: Params) -> Cache:
    """Last (d_conv - 1) pre-conv channel inputs, bf16, for decode warm-start."""
    u = u[:, -(cfg.ssm.d_conv - 1):]
    # under a mesh the products' partial sums are summed before the cast
    x = _summed(linear(u, mp["in_x"])).to(ssm.CONV_DTYPE)
    if _mamba1(cfg):
        return {"conv": x}
    return {"conv_x": x, "conv_bc": _summed(linear(u, mp["in_bc"])).to(ssm.CONV_DTYPE)}


def _at(states: Cache, i: int) -> Cache:
    """Layer (or group) i of stacked states: views, written in place."""
    return {k: v[i] for k, v in states.items()}


# ===================================================================== #
#  Pure SSM stack (falcon-mamba)                                         #
# ===================================================================== #
def ssm_stack_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16,
                   n_layers: Optional[int] = None) -> Params:
    """Stacked (L, ...) parameters, the shape of the reference's tree."""
    n = cfg.n_layers if n_layers is None else n_layers
    return stack_init(lambda: ssm_layer_init(gen, cfg, dtype), n)


def ssm_stack_fwd(sp: Params, cfg: ModelConfig, x, ctx=LOCAL_CTX):
    """A remat region is one layer, as in the reference."""
    layer = _remat(lambda x, lp: ssm_layer_fwd(lp, cfg, x, ctx), cfg.remat_policy)
    for lp in unstack(sp):
        x = layer(x, lp)
    return x


def ssm_stack_prefill(sp: Params, cfg: ModelConfig, x, states: Cache, ctx=LOCAL_CTX):
    """Forward over the prompt, writing each layer's final state and conv
    tail into ``states`` ((L, ...) tensors, as ``init_cache`` makes them).
    Returns x."""
    for i, lp in enumerate(unstack(sp)):
        x = ssm_layer_prefill(lp, cfg, x, _at(states, i), ctx)
    return x


def ssm_stack_decode(sp: Params, cfg: ModelConfig, x, states: Cache, ctx=LOCAL_CTX):
    """One token through the stack; ``states`` are updated in place."""
    for i, lp in enumerate(unstack(sp)):
        x, _ = ssm_layer_step(lp, cfg, x, _at(states, i), ctx)
    return x


# ===================================================================== #
#  Hybrid stack (zamba2): groups of k SSM layers + SHARED attn block     #
# ===================================================================== #
def hybrid_split(cfg: ModelConfig) -> Tuple[int, int]:
    """(groups of ``hybrid_attn_every`` SSM layers, SSM layers in the tail)."""
    k = cfg.hybrid_attn_every
    g = cfg.n_layers // k
    return g, cfg.n_layers - g * k


def hybrid_stack_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16) -> Params:
    """``ssm`` (g, k, ...), ONE ``shared_attn`` block, ``tail`` (tail, ...) or
    None: the reference's tree."""
    g, tail = hybrid_split(cfg)
    k = cfg.hybrid_attn_every
    return {"ssm": stack_init(lambda: ssm_stack_init(gen, cfg, dtype, k), g),
            "shared_attn": layer_init(gen, cfg, dtype),
            "tail": ssm_stack_init(gen, cfg, dtype, tail) if tail else None}


def hybrid_stack_fwd(sp: Params, cfg: ModelConfig, x, ctx=LOCAL_CTX):
    """A remat region is a group (its SSM layers and the shared block) or a
    layer of the tail, as in the reference."""
    def group(x, gp, shared):
        for lp in unstack(gp):
            x = ssm_layer_fwd(lp, cfg, x, ctx)
        return layer_fwd(shared, cfg, x, kind="causal", ctx=ctx)[0]

    group = _remat(group, cfg.remat_policy)
    for gp in unstack(sp["ssm"]):
        x = group(x, gp, sp["shared_attn"])
    if sp["tail"] is not None:
        x = ssm_stack_fwd(sp["tail"], cfg, x, ctx)
    return x


def hybrid_stack_prefill(sp: Params, cfg: ModelConfig, x, states: Cache,
                         tail_states: Optional[Cache], ctx=LOCAL_CTX):
    """Forward over the prompt, writing every SSM layer's state into
    ``states`` ((g, k, ...) tensors) and ``tail_states`` ((tail, ...)) in
    place. Returns (x, (k, v)): the shared block's keys and values of each
    group, (g, B, S, KVH, D)."""
    ks, vs = [], []
    for i, gp in enumerate(unstack(sp["ssm"])):
        x = ssm_stack_prefill(gp, cfg, x, _at(states, i), ctx)
        x, (k, v), _ = layer_fwd(sp["shared_attn"], cfg, x, kind="causal", ctx=ctx)
        ks.append(k)
        vs.append(v)
    if sp["tail"] is not None:
        x = ssm_stack_prefill(sp["tail"], cfg, x, tail_states, ctx)
    return x, (torch.stack(ks), torch.stack(vs))


def hybrid_stack_decode(sp: Params, cfg: ModelConfig, x, states: Cache, cache_k,
                        cache_v, tail_states: Optional[Cache], pos, ctx=LOCAL_CTX):
    """One token through the stack. The SSM states and group i's slice of
    the shared block's cache, ``cache_{k,v}[i]`` (B, Smax, KVH, D), are
    updated in place."""
    for i, gp in enumerate(unstack(sp["ssm"])):
        x = ssm_stack_decode(gp, cfg, x, _at(states, i), ctx)
        x = layer_decode(sp["shared_attn"], cfg, x, cache_k[i], cache_v[i], pos, ctx=ctx)
    if sp["tail"] is not None:
        x = ssm_stack_decode(sp["tail"], cfg, x, tail_states, ctx)
    return x
