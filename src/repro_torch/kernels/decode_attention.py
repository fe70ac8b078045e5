"""Decode attention: the wrapper of the CUDA kernels ``csrc/flash_decode.cu``
and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/decode_attention.py``
(``flash_decode_bkgd``). Bound by the bytes of the valid part of the cache
on the card. The keys are split over blocks of about 128 keys each, so
that the longest serial walk is short and a small batch still fills the
SMs, and a second small kernel merges the partial ``(m, l, acc)`` of the
splits (two passes, always); ``merge_partials_plain`` is that merge in
PyTorch. The cache is read in the model's layout ``(B, T, KVH, D)``
through strides: nothing is transposed or copied. The lengths are read as
the caller has them, int32 or int64. At head_dim 256 the kernels take at
most 8 query heads a KV head (no config has more there).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)   # head sizes the kernels are built for
MAX_GROUP = 16                   # most query heads per KV head (DEC_MAXG) ...
MAX_GROUP_256 = 8                # ... and at head_dim 256
_TILE = 64                       # a split is whole tiles of every stage size (32, 64)
_SPLIT_KEYS = 128                # keys a split, the serial work of one block
_MAX_BLOCKS = 8 * 132            # eight blocks for each of the card's 132 SMs
_MAX_SPLITS = 32
LEN_DTYPES = {torch.int32: 0, torch.int64: 1}   # len_is_64 of rt_flash_decode


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       kv_len: torch.Tensor) -> torch.Tensor:
    """q: (B, 1, H, D); k, v: (B, T, KVH, D); kv_len: (B,) valid lengths.
    Scores and softmax in f32, the weights cast to ``v.dtype`` before the
    weighted sum, which comes out in ``v.dtype``. Returns (B, 1, H, D) in
    ``q.dtype``."""
    B, _, H, D = q.shape
    T, KVH = k.shape[1], k.shape[2]
    qg = q.reshape(B, KVH, H // KVH, D).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) / math.sqrt(D)
    ok = torch.arange(T, device=q.device)[None, :] < kv_len.reshape(B, 1)
    s = torch.where(ok[:, None, None, :], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1).to(v.dtype).float()
    o = torch.einsum("bkgt,btkd->bkgd", w, v.float())
    return o.reshape(B, 1, H, D).to(v.dtype).to(q.dtype)


def split_plan(T: int, n_pairs: int) -> tuple:
    """(keys per split, number of splits) for a cache of T positions and
    ``n_pairs`` = batch x KV heads: splits of ``_SPLIT_KEYS`` keys, so that
    no block walks far, unless the card already holds ``_MAX_BLOCKS``
    blocks or the splits would pass ``_MAX_SPLITS``: then fewer, longer
    ones. Whole tiles per split."""
    want = min(_MAX_SPLITS, -(-T // _SPLIT_KEYS), max(1, _MAX_BLOCKS // max(1, n_pairs)))
    per_split = -(-T // max(1, want))
    chunk = max(_TILE, -(-per_split // _TILE) * _TILE)
    return chunk, max(1, -(-T // chunk))


def merge_partials_plain(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                         out_dtype: torch.dtype) -> torch.Tensor:
    """The merge kernel's function: m, l (..., n_splits) and acc (...,
    n_splits, D) are each split's running maximum (natural-log domain),
    sum of weights and weighted sum of values; returns ``sum_s w_s acc_s /
    max(sum_s w_s l_s, 1e-30)`` with ``w_s = exp(m_s - max_s m_s)``, passed
    through ``out_dtype`` (the values' type). A split that saw no key has
    m = -1e30 and l = 0 and drops out."""
    w = torch.exp(m - m.amax(dim=-1, keepdim=True))
    num = (w[..., None] * acc).sum(dim=-2)
    den = (w * l).sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return (num / den).to(out_dtype)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: torch.Tensor) -> torch.Tensor:
    """q: (B, 1, H, D); k, v: (B, T, KVH, D), possibly strided views of the
    cache; kv_len: (B,) int32 or int64 tensor, each >= 1. A tensor on the
    CPU takes the plain version; a CUDA tensor launches the kernels or
    raises."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    B, one, H, D = q.shape
    T, KVH = k.shape[1], k.shape[2]
    if one != 1 or k.shape != (B, T, KVH, D) or v.shape != k.shape:
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} do not fit")
    _build.check_dtypes("flash_decode", q, k, v)
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_decode: head_dim {D} not in {HEAD_DIMS}")
    most = MAX_GROUP_256 if D > 128 else MAX_GROUP
    if H % KVH or H // KVH > most:
        raise ValueError(f"flash_decode: {H} heads over {KVH} KV heads "
                         f"(at most {most} per KV head at head_dim {D})")
    if not (k.device == v.device == kv_len.device == q.device):
        raise ValueError("flash_decode: all tensors must be on one device")
    if kv_len.shape != (B,):
        raise ValueError(f"flash_decode: kv_len must be ({B},), got "
                         f"{tuple(kv_len.shape)}")
    if kv_len.dtype not in LEN_DTYPES:
        raise TypeError(f"flash_decode: kv_len must be int32 or int64, got {kv_len.dtype}")
    kv_len = kv_len.contiguous()
    q = q.contiguous()
    _build.check_rows_aligned("flash_decode: k", k, *k.stride()[:3])
    _build.check_rows_aligned("flash_decode: v", v, *v.stride()[:3])
    G = H // KVH
    chunk, n_splits = split_plan(T, B * KVH)
    o = torch.empty_like(q)
    part_ml = torch.empty((2, B, KVH, n_splits, G), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((B, KVH, n_splits, G, D), dtype=torch.float32,
                           device=q.device)
    rc = _build.load().rt_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        o.data_ptr(), part_ml[0].data_ptr(), part_ml[1].data_ptr(),
        part_acc.data_ptr(), B, T, H, KVH, D, chunk, n_splits,
        q.stride(0), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), o.stride(0), o.stride(2),
        _build.DTYPE_CODES[q.dtype], _build.DTYPE_CODES[k.dtype],
        LEN_DTYPES[kv_len.dtype], _build.stream_ptr())
    _build.check_launch(rc, f"flash_decode q{tuple(q.shape)} k{tuple(k.shape)}")
    flash_decode.launches += 1
    return o


flash_decode.launches = 0    # launches of the CUDA kernels by this wrapper
