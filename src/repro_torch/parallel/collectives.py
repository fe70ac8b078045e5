"""Distributed-optimization collectives, the twin of
``src/repro/parallel/collectives.py``: so far the int8 quantiser of the
gradients, ``compress_grads_int8``, which the train step applies with
``RunConfig.use_grad_compression``. The compressed all-reduce over a
process group (``psum_int8`` and the ring variant) waits for the parallel
layer (ROADMAP A10).
"""
from __future__ import annotations

import torch

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
