"""Pipeline parallelism: the GPipe schedule over one axis of a
``DeviceMesh``, with ``torch.distributed`` sends and receives between
neighbouring ranks; the twin of ``src/repro/parallel/pipeline.py``.

Stages hold disjoint layer blocks (``stage_params``' leading dim is the
stage; each rank takes its own). Microbatches stream through the same tick
schedule as the reference's: at tick t stage 0 takes microbatch t, every
other stage the activation its neighbour sent at tick t - 1, and the last
stage's result at tick t is microbatch t - (S - 1). The send to the next
stage is the twin of the reference's ``ppermute`` over the ring, an
``autograd.Function`` whose backward is the reverse permute, so the same
function trains. As in the reference's SPMD program, every rank computes
every tick (stage 0 ignores what it receives, the last stage alone writes
the outputs) and the result is the last stage's outputs on every rank:
every rank is to run the same loss on it and call ``backward``, which
walks the ticks in reverse on all ranks together; each rank's stage
parameters then hold their gradients.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.tree import map_leaves


def _shift(x: torch.Tensor, step: int, group) -> torch.Tensor:
    """Send x to the rank ``step`` ahead on the ring of ``group`` and
    return what the rank ``step`` behind sent."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    out = torch.empty_like(x)
    req = dist.isend(x.contiguous(), dist.get_global_rank(group, (r + step) % n), group=group)
    dist.recv(out, dist.get_global_rank(group, (r - step) % n), group=group)
    req.wait()
    return out


class _Ring(torch.autograd.Function):
    """ppermute over the ring i -> i + 1; its transpose is i -> i - 1."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        return _shift(y, 1, group)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, -1, ctx.group), None


class _FromLast(torch.autograd.Function):
    """The last rank's tensor on every rank (a broadcast). The loss is the
    same on every rank, so its cotangent is taken once: the last rank's
    goes back to its outputs, the others' are zeros."""

    @staticmethod
    def forward(ctx, x, group):
        n = dist.get_world_size(group)
        ctx.last = dist.get_rank(group) == n - 1
        out = x.clone()
        dist.broadcast(out, dist.get_global_rank(group, n - 1), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None


def pipeline_apply(mesh, axis: str, stage_fn: Callable,
                   stage_params, microbatches: torch.Tensor) -> torch.Tensor:
    """Run ``microbatches`` (n_micro, mb, ...) through the stages of
    ``mesh``'s ``axis``. stage_params: a tree whose leaves have leading
    dim n_stages (``split_stages``); stage_fn(params_slice, x) -> y must
    preserve x's shape. Returns outputs (n_micro, mb, ...): activations
    after the last stage, on every rank."""
    group = mesh.get_group(axis)
    n_stages = dist.get_world_size(group)
    idx = dist.get_rank(group)
    n_micro = microbatches.shape[0]
    T = n_micro + n_stages - 1
    params = map_leaves(lambda p: p[idx], stage_params)          # local stage slice
    first = torch.tensor(idx == 0, device=microbatches.device)
    buf = torch.zeros_like(microbatches[0])
    outs = torch.zeros_like(microbatches)
    for t in range(T):
        inject = microbatches[min(max(t, 0), n_micro - 1)]
        x = torch.where(first, inject, buf)
        y = stage_fn(params, x)
        # the LAST stage's result at tick t is microbatch t-(S-1)
        out_idx = t - (n_stages - 1)
        if out_idx >= 0:
            upd = outs.index_copy(0, torch.tensor([out_idx], device=outs.device),
                                  y[None].to(outs.dtype))
            outs = torch.where(torch.tensor(idx == n_stages - 1, device=outs.device),
                               upd, outs)
        if t < T - 1:                    # the last tick's send reaches no tick
            buf = _Ring.apply(y, group) if n_stages > 1 else y
    return _FromLast.apply(outs, group) if n_stages > 1 else outs


def split_stages(stacked_params, n_stages: int):
    """(L, ...) stacked layer params -> (n_stages, L/n_stages, ...)."""
    def re(p):
        L = p.shape[0]
        assert L % n_stages == 0, f"{L} layers not divisible by {n_stages} stages"
        return p.reshape(n_stages, L // n_stages, *p.shape[1:])

    return map_leaves(re, stacked_params)
