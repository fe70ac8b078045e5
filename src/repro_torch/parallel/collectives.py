"""Distributed-optimization collectives, the twin of
``src/repro/parallel/collectives.py``: the int8 quantiser of the
gradients, ``compress_grads_int8``, which the train step applies with
``RunConfig.use_grad_compression``, and the compressed all-reduce over a
``torch.distributed`` process group, ``psum_int8``, with
``ring_allreduce_int8`` applying it to every leaf of a tree.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.tree import map_leaves


def quantize_int8(x: torch.Tensor):
    """(q int8, scale f32): x / scale rounded to the nearest (ties to even)
    and clipped to [-127, 127], scale = max|x| / 127 + 1e-12."""
    xf = x.float()
    scale = xf.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_grads_int8(grads):
    """Per-leaf int8 quantize -> dequantize (error bounded by 1/254 of the
    leaf's max), each leaf back in its own type; a scalar or a leaf of
    fewer than 4,096 elements, and a ``None``, pass unchanged."""
    def comp(g):
        if g.ndim == 0 or g.numel() < 4096:
            return g
        q, s = quantize_int8(g)
        return dequantize_int8(q, s).to(g.dtype)

    return map_leaves(comp, grads)


def psum_int8(x: torch.Tensor, group=None) -> torch.Tensor:
    """Compressed all-reduce of ``x`` over ``group``, the reference's
    arithmetic: each rank quantises with its own scale, the int8 payloads
    are summed widened to int32 (exact), and the sum is multiplied by the
    **largest** of the ranks' scales. That is not the dequantised sum
    (sum_r q_r * s_r) unless the scales are equal: a rank of smaller scale
    has its share scaled up by s_max / s_r. The reference does the same;
    kept as it is. Returns f32."""
    q, s = quantize_int8(x)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    s_max = s.clone()
    dist.all_reduce(s_max, op=dist.ReduceOp.MAX, group=group)
    return total.float() * s_max


def ring_allreduce_int8(group=None):
    """The compressed all-reduce of a tree over ``group``: returns
    ``call(tree)``, ``psum_int8`` at every leaf (``None`` stays)."""
    def call(tree):
        return map_leaves(lambda x: psum_int8(x, group), tree)

    return call
