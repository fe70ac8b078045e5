"""Model-layout entry points of the kernels, the twins of
``src/repro/kernels/ops.py``. On a CUDA tensor each launches its kernel; on
a CPU tensor each computes the same function with the kernel's plain
version (there is no switch between the two)."""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import ssm_scan as _ssm


def flash_attention(q, k, v, *, kind: str = "causal", window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0, offsets=None):
    """q (B,S,H,D); k/v (B,T,KVH,D) -> (B,S,H,D). The mask compares
    ``k_pos`` with ``q_pos + q_offset``; ``offsets``, a device tensor
    ``[slot, pos0, c]``, puts slot, pos0 and the valid keys in device memory
    (``kernels/flash_attention.py``). (softcap is not in the kernel and is
    refused.)"""
    if softcap:
        raise NotImplementedError("flash_attention: softcap is not implemented in the kernel")
    return _fa.flash_attention(q, k, v, kind, window, q_offset, offsets=offsets)


def flash_decode(q, k, v, kv_len):
    """q (B,1,H,D); k/v (B,T,KVH,D); kv_len an int, () or (B,) -> (B,1,H,D).
    An integer tensor is handed over in its own type (int32 or int64): no
    cast on the way."""
    B = q.shape[0]
    kv_len = torch.as_tensor(kv_len, device=q.device)
    return _dec.flash_decode(q, k, v, kv_len.reshape(-1).expand(B))


def rmsnorm(x, scale, eps: float = 1e-6):
    """x (..., d); scale (d,)."""
    return _rms.rmsnorm(x, scale, eps)


def ssm_scan(x, dt, A, B, C):
    """x, dt (Bb,S,di); A (di,N); B, C (Bb,S,N) -> y (Bb,S,di) in ``x.dtype``,
    as the Pallas kernel returns it (the model's scan keeps y in f32 and the
    final state: ``kernels/ssm_scan.py``)."""
    y, _ = _ssm.ssm_scan(x, dt.float(), A.float(), B.float(), C.float())
    return y.to(x.dtype)
