"""The attention prologue of the decode and extend steps: the wrapper of the
CUDA kernel ``csrc/rope_write.cu`` and its plain PyTorch version.

Replaces no TPU kernel: the reference's XLA fuses this chain, which eager
PyTorch runs as some fifty small launches a layer. One launch takes the
three projections' heads, applies the per-head qk-norm where the model has
its scales and RoPE at each row's position, returns the rotated q and
writes the rotated k and the v rows into the layer's cache: a decode step's
row b at ``pos[b]`` (``pos[b] % Smax`` in a ``"local"`` ring), with the
lengths ``min(pos + 1, Smax)`` that the decode attention reads; an extend
step's chunk at the flat rows ``attention.chunk_rows`` gives, the padding
to the trash position. Positions and rows are read from device memory, so
the launch captures into the steps' CUDA graphs. The rounding points are
the plain version's; only the order of the norm's sum of squares differs.
The inverse frequencies are ``rope_frequencies``' own, made once a head
size, theta and device. ``admit`` is what the wrapper takes, checked before
any launch. Over DTensors the wrapper runs the plain version, the eager
chain with each rank writing its block of the cache; on the card it writes
the caches in place and has no gradient.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, _grad, _mesh
from repro_torch.kernels.decode_attention import HEAD_DIMS

POS_DTYPES = {torch.int32: 0, torch.int64: 1}      # pos_is_64 of rt_rope_write
EPS = 1e-6                                         # ``layers.l2norm``'s
_inv_freq = {}                                     # (D, theta, device) -> (D / 2,) f32


def rope_write_plain(q, k, v, cache_k, cache_v, positions, rows=None, *, theta: float,
                     q_norm=None, k_norm=None, ring: bool = False, offsets=None):
    """q (B, S, H, D), k and v (B, S, KVH, D): the projections' heads;
    positions (B, S); cache_{k,v} (B_slots, Smax, KVH, D), written in
    place. ``rows`` None: a decode step (S 1), row b written at slot b,
    position ``positions[b]`` (modulo Smax where ``ring``); else a chunk (B
    1) written at the flat cache rows ``rows`` (C,), or, into a DTensor
    cache, rank by rank at ``offsets`` (``[slot, pos0, c]``, as
    ``attention.chunk_rows`` takes them; the padding is not written).
    ``q_norm`` and ``k_norm`` (D,): the qk-norm's scales, or None. Returns
    (the normed, rotated q, and a decode's lengths ``min(pos + 1, Smax)``
    (B,) or None for a chunk)."""
    # the models import the kernels: theirs are imported at the call
    from repro_torch.models import attention
    from repro_torch.models.layers import qk_norm_rope
    q, k = qk_norm_rope(q, k, positions, theta, q_norm, k_norm)
    if rows is not None and _mesh.is_dtensor(cache_k):
        attention._write_chunk_sharded(cache_k, k, offsets)
        attention._write_chunk_sharded(cache_v, v, offsets)
        return q, None
    if rows is not None:
        KVH, D = cache_k.shape[-2:]
        cache_k.view(-1, KVH, D).index_copy_(0, rows, k[0].to(cache_k.dtype))
        cache_v.view(-1, KVH, D).index_copy_(0, rows, v[0].to(cache_v.dtype))
        return q, None
    smax = cache_k.shape[1]
    pos = positions.reshape(-1)
    slot = pos % smax if ring else pos
    attention.write_kv(cache_k, k, slot)
    attention.write_kv(cache_v, v, slot)
    return q, torch.clamp(pos + 1, max=smax)


def rope_write(q, k, v, cache_k, cache_v, positions, rows=None, *, theta: float,
               q_norm=None, k_norm=None, ring: bool = False, offsets=None):
    """``rope_write_plain``'s function. A tensor on the CPU takes the plain
    version, and so does one on ``meta`` (shapes only: the dry run's
    count) and a DTensor (the eager chain, each rank writing its block);
    a CUDA tensor launches the kernel or raises. The kernel writes the
    caches in place and has no gradient: where one is wanted on the card
    the wrapper raises (the training forward takes ``project_qkv``)."""
    if _mesh.any_dtensor(q, k, v, cache_k, cache_v) or q.device.type in ("cpu", "meta"):
        return rope_write_plain(q, k, v, cache_k, cache_v, positions, rows, theta=theta,
                                q_norm=q_norm, k_norm=k_norm, ring=ring, offsets=offsets)
    if _grad.needs_grad(q, k, v, q_norm, k_norm):
        raise RuntimeError("rope_write (it writes the caches in place) has no gradient: "
                           "call it under torch.no_grad()")
    if q.device.type != "cuda":
        raise ValueError(f"rope_write: unsupported device {q.device}")
    admit(q, k, v, cache_k, cache_v, positions, rows, q_norm, k_norm)
    B, S, H, D = q.shape
    KVH = k.shape[2]
    n_slots, smax = cache_k.shape[:2]
    q3, k3, v3 = q.reshape(B * S, H, D), k.reshape(B * S, KVH, D), v.reshape(B * S, KVH, D)
    pos = positions.reshape(-1)
    out = torch.empty((B * S, H, D), dtype=q.dtype, device=q.device)
    kv_len = None if rows is not None else torch.empty((B,), dtype=pos.dtype, device=q.device)
    norm_dtype = -1 if q_norm is None else _build.DTYPE_CODES[q_norm.dtype]
    rc = _build.load().rt_rope_write(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), out.data_ptr(),
        cache_k.data_ptr(), cache_v.data_ptr(), pos.data_ptr(),
        None if rows is None else rows.data_ptr(),
        None if kv_len is None else kv_len.data_ptr(),
        None if q_norm is None else q_norm.data_ptr(),
        None if k_norm is None else k_norm.data_ptr(),
        _inverse_frequencies(D, theta, q.device).data_ptr(),
        B * S, H, KVH, D, n_slots, smax,
        q3.stride(0), q3.stride(1), k3.stride(0), k3.stride(1), v3.stride(0), v3.stride(1),
        out.stride(0), out.stride(1), *cache_k.stride()[:3], *cache_v.stride()[:3],
        pos.stride(0), EPS, int(ring), _build.DTYPE_CODES[q.dtype],
        _build.DTYPE_CODES[cache_k.dtype], norm_dtype, POS_DTYPES[pos.dtype],
        _build.stream_ptr())
    _build.check_launch(rc, f"rope_write q{tuple(q.shape)} cache{tuple(cache_k.shape)}")
    rope_write.launches += 1
    return out.view(q.shape), kv_len


def _inverse_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    """``rope_frequencies(head_dim, theta, device)``, made at the first call
    for these arguments and kept: the values the eager chain computes on
    every call. A first call inside a CUDA graph's capture raises (the table
    would live in the graph's memory); the steps' warm-up makes it first."""
    key = (head_dim, float(theta), torch.device(device))
    if key not in _inv_freq:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("rope_write: the inverse frequencies are first wanted inside "
                               "a CUDA graph capture; run the step once before capturing it")
        from repro_torch.models.layers import rope_frequencies
        _inv_freq[key] = rope_frequencies(head_dim, theta, device)
    return _inv_freq[key]


def admit(q, k, v, cache_k, cache_v, positions, rows=None, q_norm=None, k_norm=None) -> None:
    """The shapes and types the kernel takes, as the wrapper checks them
    before any launch: raises ValueError or TypeError naming the wrapper."""
    B, S, H, D = q.shape
    KVH = k.shape[2]
    if k.shape != (B, S, KVH, D) or v.shape != k.shape:
        raise ValueError(f"rope_write: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not fit")
    if D not in HEAD_DIMS:
        raise ValueError(f"rope_write: head_dim {D} not in {HEAD_DIMS}")
    if H % KVH:
        raise ValueError(f"rope_write: {H} heads over {KVH} KV heads")
    if cache_k.dim() != 4 or cache_k.shape[2:] != (KVH, D) or cache_v.shape != cache_k.shape:
        raise ValueError(f"rope_write: caches k {tuple(cache_k.shape)} v "
                         f"{tuple(cache_v.shape)} do not take ({KVH}, {D}) rows")
    if positions.shape != (B, S):
        raise ValueError(f"rope_write: positions must be ({B}, {S}), got {tuple(positions.shape)}")
    if rows is None and (S != 1 or B != cache_k.shape[0]):
        raise ValueError(f"rope_write: a decode step takes one row for each of the cache's "
                         f"{cache_k.shape[0]} slots, got ({B}, {S})")
    if rows is not None and (B != 1 or rows.shape != (S,) or rows.dtype != torch.int64):
        raise ValueError(f"rope_write: a chunk takes one slot's int64 rows ({S},), got "
                         f"B {B}, rows {tuple(rows.shape)} {rows.dtype}")
    if (q_norm is None) != (k_norm is None):
        raise ValueError("rope_write: give both qk-norm scales or neither")
    if q_norm is not None and (q_norm.shape != (D,) or k_norm.shape != (D,)
                               or q_norm.dtype != k_norm.dtype
                               or q_norm.dtype not in _build.DTYPE_CODES):
        raise ValueError(f"rope_write: qk-norm scales {tuple(q_norm.shape)} {q_norm.dtype} / "
                         f"{tuple(k_norm.shape)} {k_norm.dtype} for head_dim {D}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"rope_write: unsupported dtypes q {q.dtype} k {k.dtype} v {v.dtype}")
    # the caches' types are those their readers, the attention kernels, take
    _build.check_dtypes("rope_write", q, cache_k, cache_v)
    if positions.dtype not in POS_DTYPES:
        raise TypeError(f"rope_write: positions must be int32 or int64, got {positions.dtype}")
    tensors = [q, k, v, cache_k, cache_v, positions] + [t for t in (rows, q_norm, k_norm)
                                                        if t is not None]
    if any(t.device != q.device for t in tensors):
        raise ValueError("rope_write: all tensors must be on one device")
    if any(t.stride(-1) != 1 for t in (q, k, v, cache_k, cache_v, q_norm, k_norm)
           if t is not None):
        raise ValueError("rope_write: the head dimension must have stride 1")


rope_write.launches = 0     # launches of the CUDA kernel by this wrapper
