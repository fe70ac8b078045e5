"""SSM stacks (falcon-mamba): the pure-SSM half of
``src/repro/models/hybrid.py``.

The reference's ``lax.scan`` over stacked ``(L, ...)`` layer parameters is a
Python loop over the same stacked tensors (``transformer.unstack``), so the
parameter tree keeps the reference's shape. Per-layer states are stacked
``(L, ...)`` tensors too, written in place by prefill and by every decode
step. The hybrid stack (zamba2: Mamba-2 layers and one shared attention
block) is not ported yet (ROADMAP A6b).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm
from repro_torch.models.layers import Params, rmsnorm, rmsnorm_init
from repro_torch.models.transformer import _stack_trees, unstack

Cache = Dict[str, torch.Tensor]


def _mamba1_only(cfg: ModelConfig) -> None:
    if cfg.ssm.variant != "mamba1":
        raise NotImplementedError(
            f"{cfg.name}: ssm variant {cfg.ssm.variant!r} is not ported yet "
            "(ROADMAP.md item A6b (Mamba-2 SSD and the hybrid stack))")


# --------------------------------------------------------------------- #
#  One SSM residual layer                                                #
# --------------------------------------------------------------------- #
def ssm_layer_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16) -> Params:
    _mamba1_only(cfg)
    return {"ln": rmsnorm_init(cfg.d_model, gen.device),
            "mixer": ssm.mamba1_init(gen, cfg, dtype)}


def ssm_layer_fwd(lp: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return x + ssm.mamba1_forward(lp["mixer"], cfg, rmsnorm(lp["ln"], x, cfg.norm_eps))


def ssm_layer_step(lp: Params, cfg: ModelConfig, x, state):
    out, state = ssm.mamba1_step(lp["mixer"], cfg, rmsnorm(lp["ln"], x, cfg.norm_eps),
                                 state)
    return x + out, state


def ssm_init_state(cfg: ModelConfig, batch: int, device):
    _mamba1_only(cfg)
    return ssm.mamba1_init_state(cfg, batch, device)


# ===================================================================== #
#  Pure SSM stack (falcon-mamba)                                         #
# ===================================================================== #
def ssm_stack_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16) -> Params:
    """Stacked (L, ...) parameters, the shape of the reference's tree."""
    return _stack_trees([ssm_layer_init(gen, cfg, dtype) for _ in range(cfg.n_layers)])


def ssm_stack_fwd(sp: Params, cfg: ModelConfig, x):
    for lp in unstack(sp):
        x = ssm_layer_fwd(lp, cfg, x)
    return x


def ssm_stack_prefill(sp: Params, cfg: ModelConfig, x, states: Cache):
    """Forward over the prompt, writing each layer's final SSM state and the
    last ``d_conv - 1`` pre-conv inputs into ``states`` ((L, ...) tensors,
    as ``init_cache`` makes them). Returns x."""
    for i, lp in enumerate(unstack(sp)):
        mp = lp["mixer"]
        u = rmsnorm(lp["ln"], x, cfg.norm_eps)
        xx, z, dt, A, B, C = ssm._mamba1_inputs(mp, cfg, u)
        y, _ = ssm.mamba1_scan(xx, dt, A, B, C, out_state=states["h"][i])
        x = x + ssm._mamba1_out(mp, y, xx, z, u.dtype)
        states["conv"][i].copy_(_conv_tail(cfg, u, mp))
    return x


def _conv_tail(cfg: ModelConfig, u: torch.Tensor, mp: Params) -> torch.Tensor:
    """Last (d_conv - 1) pre-conv channel inputs, for decode warm-start."""
    K = cfg.ssm.d_conv
    return (u[:, -(K - 1):] @ mp["in_x"]).to(ssm.CONV_DTYPE)


def ssm_stack_decode(sp: Params, cfg: ModelConfig, x, states: Cache):
    """One token through the stack; ``states`` are updated in place."""
    for i, lp in enumerate(unstack(sp)):
        x, _ = ssm_layer_step(lp, cfg, x, {"conv": states["conv"][i],
                                           "h": states["h"][i]})
    return x
