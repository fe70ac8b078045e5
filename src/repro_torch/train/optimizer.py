"""Functional optimizers, the twin of ``src/repro/train/optimizer.py``: AdamW
and Adafactor, with global-norm clipping and a warmup + cosine schedule.

They are written out as the reference writes them, not taken from
``torch.optim``: every update is computed in f32 from the gradient and the
parameter (whatever their types) and cast back to each parameter's type,
so that a step can be compared with the reference's number for number
(``torch.optim.AdamW`` computes a bf16 parameter's update in bf16, and
orders its decoupled decay differently). The trees are the parameters'
nested dicts; the states have the reference's keys (``{"m", "v",
"count"}`` and ``{"s", "count"}``, ``count`` an int32 scalar).

Where the reference returns new trees, ``update`` writes the new
parameters and moments into the given tensors, under ``torch.no_grad()``:
a second copy of the moments of a 1.7 B-parameter model would not be free.
A ``None`` gradient (a leaf the loss does not reach, as hubert's embedding,
or an empty ``(0, ...)`` stack) counts as zeros: weight decay still moves
the leaf, as the reference's does.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Tuple, Union

import torch

from repro_torch.tree import leaves, map_leaves

F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]  # (grads, state, params)
    name: str


def _zeros_where_none(grads, params):
    return map_leaves(lambda p, g: torch.zeros_like(p) if g is None else g, params, grads)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    total = sum(leaf.float().square().sum() for leaf in leaves(tree))
    return torch.sqrt(torch.as_tensor(total, dtype=F32))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / norm), each in its own type; norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return map_leaves(lambda g: (g.float() * scale).to(g.dtype), grads), norm


# --------------------------------------------------------------------- #
#  Schedules                                                             #
# --------------------------------------------------------------------- #
def warmup_cosine(base_lr: float, warmup: int, total: int,
                  min_ratio: float = 0.1) -> Callable[[torch.Tensor], torch.Tensor]:
    def lr(step):
        step = torch.as_tensor(step, dtype=F32)
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)

    return lr


def _lr_fn(lr: Union[Callable, float]) -> Callable:
    return lr if callable(lr) else (lambda _: torch.tensor(lr, dtype=F32))


# --------------------------------------------------------------------- #
#  AdamW                                                                 #
# --------------------------------------------------------------------- #
def adamw(lr: Union[Callable, float] = 1e-3, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          clip_norm: float = 1.0, moment_dtype=F32) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
        some = leaves(params)
        return {"m": map_leaves(zeros, params), "v": map_leaves(zeros, params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=some[0].device if some else None)}

    @torch.no_grad()
    def update(grads, state, params):
        grads, _ = clip_by_global_norm(_zeros_where_none(grads, params), clip_norm)
        count = state["count"] + 1
        c = count.float()
        bc1 = 1 - b1 ** c
        bc2 = 1 - b2 ** c
        step_lr = lr_fn(count).to(c.device)

        def upd(p, g, m, v):
            gf = g.float()
            m_new = b1 * m.float() + (1 - b1) * gf
            v_new = b2 * v.float() + (1 - b2) * gf.square()
            delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
            delta = delta + weight_decay * p.float()
            p.copy_(p.float() - step_lr * delta)
            m.copy_(m_new)
            v.copy_(v_new)

        map_leaves(upd, params, grads, state["m"], state["v"])
        return params, {"m": state["m"], "v": state["v"], "count": count}

    return Optimizer(init, update, "adamw")


# --------------------------------------------------------------------- #
#  Adafactor (factored second moment, optional first moment)             #
# --------------------------------------------------------------------- #
def adafactor(lr: Union[Callable, float] = 1e-2, decay: float = 0.8,
              eps: float = 1e-30, clip_threshold: float = 1.0,
              weight_decay: float = 0.0, min_dim_factored: int = 128) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def factored(p) -> bool:
        return (p.ndim >= 2 and p.shape[-1] >= min_dim_factored
                and p.shape[-2] >= min_dim_factored)

    def init(params):
        def st(p):
            f32 = dict(dtype=F32, device=p.device)
            if factored(p):
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        some = leaves(params)
        return {"s": map_leaves(st, params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=some[0].device if some else None)}

    @torch.no_grad()
    def update(grads, state, params):
        grads = _zeros_where_none(grads, params)
        count = state["count"] + 1
        c = count.float()
        beta = 1.0 - c ** (-decay)
        step_lr = lr_fn(count).to(c.device)

        def upd(p, g, s):
            gf = g.float()
            g2 = gf.square() + eps
            if factored(p):
                vr = beta * s["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * s["vc"] + (1 - beta) * g2.mean(dim=-2)
                rms_r = vr / vr.mean(dim=-1, keepdim=True)
                u = gf / (torch.sqrt(rms_r)[..., None] * torch.sqrt(vc)[..., None, :])
                s["vr"].copy_(vr)
                s["vc"].copy_(vc)
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = gf / torch.sqrt(v)
                s["v"].copy_(v)
            # update clipping (Adafactor-style RMS clip)
            rms_u = torch.sqrt(u.square().mean() + 1e-30)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            p.copy_(p.float() - step_lr * (u + weight_decay * p.float()))

        map_leaves(upd, params, grads, state["s"])
        return params, {"s": state["s"], "count": count}

    return Optimizer(init, update, "adafactor")


def get_optimizer(name: str, lr=None, total_steps: int = 10000) -> Optimizer:
    sched = warmup_cosine(lr or (3e-4 if name == "adamw" else 1e-2),
                          warmup=min(1000, total_steps // 10) or 1,
                          total=total_steps)
    if name == "adamw":
        return adamw(sched)
    if name == "adafactor":
        return adafactor(sched)
    raise ValueError(name)
