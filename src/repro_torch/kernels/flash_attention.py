"""Attention forward: the wrapper of the CUDA kernel
``csrc/flash_attention.cu`` and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention_bhsd``). At the serving path's shapes the card's least
time is set by the bytes of q, k, v and o, with the operations close behind;
the kernel keeps scores and weights out of device memory. One block per (batch, head, query tile) loops over the KV tiles
with ``m``, ``l`` and the output tile in registers; q, k, v and o are used
in the model's layouts through strides, so a slot's slice of the KV cache
is read in place.

``q_offset`` is added to the query position in the causal / local mask
(``k_pos <= q_pos + q_offset``). At 0 this is the reference kernel; at
``pos0`` the S queries are a prefill chunk at absolute positions
``pos0 .. pos0 + S - 1`` over the first ``pos0 + S`` rows of a cache.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)    # head sizes the kernel is built for
KINDS = {"causal": 0, "local": 1, "bidirectional": 2}   # csrc/common.cuh


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kind: str = "causal", window: int = 0,
                          q_offset: int = 0) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, T, KVH, D). Scores and softmax in f32,
    masked scores set to -1e30, the weights cast to ``v.dtype`` before the
    weighted sum, which comes out in ``v.dtype``. Returns (B, S, H, D) in
    ``q.dtype``."""
    if kind not in KINDS:
        raise ValueError(f"unknown attention kind {kind!r}")
    B, S, H, D = q.shape
    T, KVH = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, KVH, H // KVH, D).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / math.sqrt(D)
    q_pos = torch.arange(S, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(T, device=q.device)[None, :]
    if kind == "causal":
        ok = k_pos <= q_pos
    elif kind == "local":
        ok = (k_pos <= q_pos) & (k_pos > q_pos - window)
    else:
        ok = torch.ones((S, T), dtype=torch.bool, device=q.device)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1).to(v.dtype).float()
    o = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return o.reshape(B, S, H, D).to(v.dtype).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kind: str = "causal", window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, T, KVH, D), possibly strided views. A
    tensor on the CPU takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kind, window, q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if kind not in KINDS:
        raise ValueError(f"unknown attention kind {kind!r}")
    B, S, H, D = q.shape
    T, KVH = k.shape[1], k.shape[2]
    if k.shape != (B, T, KVH, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} do not fit")
    _build.check_dtypes("flash_attention", q, k, v)
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not in {HEAD_DIMS} "
                         "(256 waits for the gemma families)")
    if H % KVH:
        raise ValueError(f"flash_attention: {H} heads over {KVH} KV heads")
    if q_offset < 0 or window < 0 or (kind == "local" and window < 1):
        raise ValueError(f"flash_attention: q_offset {q_offset} / window {window}")
    if not (k.device == v.device == q.device):
        raise ValueError("flash_attention: all tensors must be on one device")
    _build.check_rows_aligned("flash_attention: q", q, *q.stride()[:3])
    _build.check_rows_aligned("flash_attention: k", k, *k.stride()[:3])
    _build.check_rows_aligned("flash_attention: v", v, *v.stride()[:3])
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    if B * S == 0:
        return o
    rc = _build.load().rt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, S, T, H, KVH, D,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        o.stride(0), o.stride(1), o.stride(2),
        KINDS[kind], int(window), int(q_offset),
        _build.DTYPE_CODES[q.dtype], _build.DTYPE_CODES[k.dtype],
        _build.stream_ptr())
    _build.check_launch(rc, f"flash_attention q{tuple(q.shape)} k{tuple(k.shape)}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0     # launches of the CUDA kernel by this wrapper
