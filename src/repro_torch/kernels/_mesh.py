"""The kernel wrappers over a device mesh: a wrapper given DTensors runs
its kernel (or, on the CPU and on ``meta``, its plain version) on each
rank's local shard, through ``torch.distributed.tensor.experimental.local_map``
at the placements the tensors already have. Nothing is redistributed here:
a placement that the wrapper cannot take (a ``Partial``, a dim the kernel
reduces over split across ranks) raises, naming it, and nothing is
replicated behind the caller's back. The models put their tensors where
the reference's sharding constraints put them before they call a wrapper
(``models/attention.py:_shard``).

``torch.distributed.tensor`` is imported at the first DTensor seen, never
at import: a process that runs no mesh never loads it.
"""
from __future__ import annotations

import functools
from typing import Callable, Sequence

import torch


@functools.lru_cache(maxsize=None)
def _types():
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    return DTensor, Shard, Replicate, Partial


def is_dtensor(x) -> bool:
    return isinstance(x, torch.Tensor) and type(x).__name__ == "DTensor" and \
        isinstance(x, _types()[0])


def any_dtensor(*xs) -> bool:
    return any(is_dtensor(x) for x in xs)


def mesh_of(*xs):
    return next(x.device_mesh for x in xs if is_dtensor(x))


def placements(x, mesh) -> tuple:
    """A DTensor's placements; a plain tensor is replicated on every rank."""
    if is_dtensor(x):
        return tuple(x.placements)
    return (_types()[2](),) * mesh.ndim


def shard_dim(p, ndim: int):
    """The tensor dim a ``Shard`` placement splits (non-negative), else None."""
    Shard = _types()[1]
    return p.dim % ndim if isinstance(p, Shard) else None


def refuse(name: str, what: str, pl, why: str):
    raise ValueError(f"{name}: {what} placed {tuple(pl)} over the mesh: {why}; "
                     "put it where the kernel can take it before the call")


def check(name: str, what: str, x, mesh, allowed_dims: Sequence[int]) -> tuple:
    """x's placements, where each is ``Replicate`` or a ``Shard`` of one of
    ``allowed_dims``; anything else (a ``Partial``, another dim) raises."""
    pl = placements(x, mesh)
    for p in pl:
        d = shard_dim(p, x.ndim)
        if d is None and not isinstance(p, _types()[2]):
            refuse(name, what, pl, f"{p} is not a shard")
        if d is not None and d not in allowed_dims:
            refuse(name, what, pl, f"dim {d} may not be split across ranks")
    return pl


def placed(x, mesh, pl):
    """x redistributed to ``pl`` where it is a DTensor placed otherwise."""
    if not is_dtensor(x) or tuple(x.placements) == tuple(pl):
        return x
    return x.redistribute(mesh, tuple(pl))


def replicated(t, mesh):
    """A plain tensor as a DTensor whole on every rank (one it is already
    goes through as it is)."""
    if is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, mesh, [_types()[2]()] * mesh.ndim, run_check=False)


def coordinate(mesh, dims: Sequence[int]) -> tuple:
    """This rank's index along the mesh dims ``dims`` (row-major), and their
    size: the block of a tensor dim split over those mesh dims."""
    idx, size = 0, 1
    for i in dims:
        n = mesh.size(i)
        idx, size = idx * n + mesh.get_local_rank(i), size * n
    return idx, size


def local(fn: Callable, mesh, args: tuple, out_pl):
    """``fn(*args)`` over the local shards of the DTensors in ``args``, each
    taken at its own placements; a plain tensor, a number or None goes in
    as it is. The result is placed by ``out_pl``: a list of placements for
    one output tensor, a tuple of such lists for several (None for no
    output). Gradients flow back placed by ``grad_placements``."""
    from torch.distributed.tensor.experimental import local_map
    given = [i for i, a in enumerate(args) if a is not None]

    def run(*present):
        full = [None] * len(args)
        for i, a in zip(given, present):
            full[i] = a
        return fn(*full)
    present = tuple(args[i] for i in given)
    in_pl = tuple(tuple(a.placements) if is_dtensor(a) else None for a in present)
    return local_map(run, out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=grad_placements(mesh, present),
                     device_mesh=mesh, redistribute_inputs=False)(*present)


def grad_placements(mesh, args) -> tuple:
    """The placements of each DTensor input's gradient out of a local
    function: its own, but ``Partial`` on a mesh dim where it is whole and
    another input is split. There the ranks computed with different blocks
    (other tokens, other heads, other experts), so each holds a part of the
    gradient, and the parts sum to it."""
    Shard, Replicate, Partial = _types()[1:4]
    split = {i for a in args if is_dtensor(a) for i, p in enumerate(a.placements)
             if isinstance(p, Shard)}
    return tuple(tuple(Partial() if i in split and isinstance(p, Replicate) else p
                       for i, p in enumerate(a.placements)) if is_dtensor(a) else None
                 for a in args)


def matmul(fn: Callable, x, w):
    """``fn(x, w)``, a product of x (..., k) and w (k, n), over each rank's
    blocks, the output placed by its operands' splits, mesh dim by mesh
    dim: x's rows split -> the output's rows split; w's columns split ->
    the output's columns split; the contraction split -> a ``Partial``
    output (its sum is left to DTensor, where it is next read), the whole
    side sliced to the split one's block where only one side splits it
    (a local slice: no data moves). Where one mesh dim splits x's rows and
    w, or x's contraction and w's columns, the smaller of the two is
    gathered on it: the weight in a prefill or a training step (FSDP's
    gather), the activations in a decode step. The gradients come back as
    ``local`` places them."""
    Shard, Replicate, Partial = _types()[1:4]
    mesh = mesh_of(x, w)
    last = x.ndim - 1
    x_small = x.numel() <= w.numel()
    # a pending sum on either side is summed first: the product of its
    # blocks would otherwise be placed as if whole
    xp, wp = ([Replicate() if isinstance(p, Partial) else p for p in placements(t, mesh)]
              for t in (x, w))
    out = []
    for i in range(mesh.ndim):
        a, b = shard_dim(xp[i], x.ndim), shard_dim(wp[i], 2)
        if (a is not None and a != last and b is not None) or (a == last and b == 1):
            if x_small:
                xp[i], a = Replicate(), None      # gather x
            else:
                wp[i], b = Replicate(), None      # gather w
        if (a, b) == (None, 0):
            xp[i], a = Shard(last), last          # slice x's contraction
        if (a, b) == (last, None):
            wp[i], b = Shard(0), 0                # slice w's contraction
        out.append(Partial() if (a, b) == (last, 0) else Shard(a) if a is not None else
                   Shard(last) if b == 1 else Replicate())
    return local(fn, mesh, (placed(x, mesh, xp), placed(w, mesh, wp)), out)


class _GradPlaced(torch.autograd.Function):
    """The identity on a DTensor, whose backward places the gradient as
    the forward tensor was placed (whole where it was a pending sum)."""

    @staticmethod
    def forward(ctx, y):
        Replicate, Partial = _types()[2:4]
        ctx.mesh = y.device_mesh
        ctx.pl = [Replicate() if isinstance(p, Partial) else p for p in y.placements]
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return placed(g, ctx.mesh, ctx.pl)


def grad_placed(y):
    """y, its gradient placed as y is (a DTensor; anything else as it is):
    a gradient that would reach a reshape split where the forward tensor
    was whole (heads that do not divide the mesh) comes back whole."""
    return _GradPlaced.apply(y) if is_dtensor(y) else y
