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
the caller has them, int32 or int64. The kernels take every head_dim of
``HEAD_DIMS`` (80 in slots of 16 lanes, 6 of them idle: a 160-byte row is
ten 16-byte slices) and any number of query heads a KV head, as the Pallas
kernel does: a block takes at most 16 of them (8 at head_dims 80 and 256),
and more run as head groups of 8, a grid axis that reads the cache once a
group.
``admit`` is what the wrapper takes, checked before any launch. Where a
gradient is wanted the wrapper runs the kernels inside
``_grad.KernelFunction``: the backward is the plain version's.

Over DTensors (``_mesh``) each rank decodes with its own shard: the batch
and the heads may be split across ranks (KV heads left whole are sliced as
``flash_attention`` slices them), and so may the cache's sequence, as the
reference's serving recipes split it over the model axis: then each rank
runs the kernel over its rows of the cache, keeps the splits' partial
``(m, l, acc)`` (``partials``), and the ranks merge them with three
activation-sized all-reduces (the max, then the rescaled sums), the
reductions the reference's partitioned softmax makes. The cache is never
gathered.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build, _grad, _mesh

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 80, 128, 256)   # head sizes the kernels are built for
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
    CPU takes the plain version, and so does one on ``meta`` (shapes only:
    the dry run's count); a CUDA tensor launches the kernels or raises. Where q, k or v requires grad (and grad mode is on), the three
    get the plain version's gradients."""
    if _mesh.any_dtensor(q, k, v, kv_len):
        return _sharded(q, k, v, kv_len)
    if _grad.needs_grad(q, k, v):
        return _grad.KernelFunction.apply(
            lambda q, k, v: _forward(q, k, v, kv_len),
            lambda q, k, v: flash_decode_plain(q, k, v, kv_len), q, k, v)
    return _forward(q, k, v, kv_len)


def partials_plain(q, k, v, kv_len):
    """The decode of q over the first ``kv_len[b]`` keys as one split's
    partials: m, l (B, KVH, G) and acc (B, KVH, G, D), in f32 (the
    weights rounded through ``v.dtype`` before the weighted sum, as
    ``flash_decode_plain`` rounds them). A length of 0 gives m = -1e30, l =
    0 and acc = 0."""
    B, _, H, D = q.shape
    T, KVH = k.shape[1], k.shape[2]
    qg = q.reshape(B, KVH, H // KVH, D).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) / math.sqrt(D)
    ok = (torch.arange(T, device=q.device)[None, :] < kv_len.reshape(B, 1))[:, None, None, :]
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.where(ok, torch.exp(s - m[..., None]), torch.zeros_like(s))
    acc = torch.einsum("bkgt,btkd->bkgd", p.to(v.dtype).float(), v.float())
    return m, p.sum(dim=-1), acc


def partials(q, k, v, kv_len):
    """``partials_plain``'s (m, l, acc), on the card from the kernels' own
    per-split partials (their maxima in the exp2 domain; the splits a row
    reaches merged here). The kernels read at least one key a row, so a row of
    length 0 runs at 1 and its partials are set to those of no key. On the
    CPU and on ``meta`` the plain version."""
    if q.device.type in ("cpu", "meta"):
        return partials_plain(q, k, v, kv_len)
    lens = torch.clamp(kv_len, min=1)
    _, part_ml, part_acc = _forward(q, k, v, lens, keep_partials=True)
    # a split past a row's length is never written (the merge kernel skips it)
    chunk, n_splits = split_plan(k.shape[1], q.shape[0] * k.shape[2])
    live = (torch.arange(n_splits, device=q.device) * chunk)[None, None, :, None] \
        < lens.reshape(-1, 1, 1, 1)
    m_s = torch.where(live, part_ml[0], NEG_INF)          # (B, KVH, splits, G)
    l_s = torch.where(live, part_ml[1], 0.0)
    part_acc = torch.where(live[..., None], part_acc, 0.0)
    top = m_s.amax(dim=2)
    w = torch.exp2(m_s - top[:, :, None])
    m, l, acc = top * math.log(2.0), (w * l_s).sum(dim=2), (w[..., None] * part_acc).sum(dim=2)
    empty = (kv_len.reshape(-1) == 0)[:, None, None]
    return (torch.where(empty, torch.full_like(m, NEG_INF), m),
            torch.where(empty, torch.zeros_like(l), l),
            torch.where(empty[..., None], torch.zeros_like(acc), acc))


def _sharded(q, k, v, kv_len):
    from repro_torch.kernels.flash_attention import kv_head_slice
    name = "flash_decode"
    mesh = _mesh.mesh_of(q, k, v, kv_len)
    qp = _mesh.check(name, "q", q, mesh, (0, 2))
    kp = _mesh.check(name, "k", k, mesh, (0, 1, 2))
    if _mesh.placements(v, mesh) != kp:
        _mesh.refuse(name, "v", _mesh.placements(v, mesh), f"k is placed {kp}")
    lp = _mesh.check(name, "kv_len", kv_len, mesh, (0,))
    head_dims, seq_dims, batch_dims = [], [], []
    for i, (a, b) in enumerate(zip(qp, kp)):
        if mesh.size(i) == 1:                 # split one way: whole
            continue
        da, db = _mesh.shard_dim(a, 4), _mesh.shard_dim(b, 4)
        if db == 1 and da is None:
            seq_dims.append(i)
        elif da == 2 and db is None:
            head_dims.append(i)
        elif da != db:
            _mesh.refuse(name, "q and the cache", (qp, kp),
                         f"mesh dim {i} splits q's dim {da} and the cache's {db}")
        if (da == 0) != (_mesh.shard_dim(lp[i], 1) == 0) and _mesh.is_dtensor(kv_len):
            _mesh.refuse(name, "kv_len", lp, f"q is placed {qp}")
        if da == 0 and not _mesh.is_dtensor(kv_len):
            batch_dims.append(i)
    if head_dims and any(_mesh.shard_dim(b, 4) == 2 for b in kp):
        _mesh.refuse(name, "q and the cache", (qp, kp),
                     "the cache's heads are split on other mesh dims")
    heads = (kv_head_slice(q.shape[2], k.shape[2], *_mesh.coordinate(mesh, head_dims))
             if head_dims else slice(None))
    cb, nb = _mesh.coordinate(mesh, batch_dims)
    cs, ns = _mesh.coordinate(mesh, seq_dims)
    Tl = k.shape[1] // ns

    def run(q, k, v, lens):
        if batch_dims:                        # a whole (B,) of lengths: this rank's rows
            lens = lens.reshape(nb, -1)[cb]
        k, v = k[:, :, heads], v[:, :, heads]
        if not seq_dims:
            return flash_decode(q, k, v, lens)
        import torch.distributed._functional_collectives as funcol
        m, l, acc = partials(q, k, v, torch.clamp(lens - cs * Tl, 0, Tl))
        top = m
        for i in seq_dims:
            top = funcol.all_reduce(top, "max", (mesh, i))
        w = torch.exp(m - top)
        l, acc = l * w, acc * w[..., None]
        for i in seq_dims:
            l = funcol.all_reduce(l, "sum", (mesh, i))
            acc = funcol.all_reduce(acc, "sum", (mesh, i))
        o = (acc / torch.clamp(l, min=1e-30)[..., None]).to(v.dtype)
        return o.reshape(q.shape).to(q.dtype)
    return _mesh.local(run, mesh, (q, k, v, kv_len), list(qp))


def admit(q, k, v, kv_len) -> None:
    """The shapes and types the kernels take, as the wrapper checks them
    before any launch: raises ValueError or TypeError naming the wrapper."""
    B, one, H, D = q.shape
    T, KVH = k.shape[1], k.shape[2]
    if one != 1 or k.shape != (B, T, KVH, D) or v.shape != k.shape:
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} do not fit")
    _build.check_dtypes("flash_decode", q, k, v)
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_decode: head_dim {D} not in {HEAD_DIMS}")
    if H % KVH:
        raise ValueError(f"flash_decode: {H} heads over {KVH} KV heads")
    if kv_len.shape != (B,):
        raise ValueError(f"flash_decode: kv_len must be ({B},), got "
                         f"{tuple(kv_len.shape)}")
    if kv_len.dtype not in LEN_DTYPES:
        raise TypeError(f"flash_decode: kv_len must be int32 or int64, got {kv_len.dtype}")


def _forward(q, k, v, kv_len, keep_partials: bool = False):
    if q.device.type in ("cpu", "meta"):
        return flash_decode_plain(q, k, v, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    admit(q, k, v, kv_len)
    if not (k.device == v.device == kv_len.device == q.device):
        raise ValueError("flash_decode: all tensors must be on one device")
    B, _, H, D = q.shape
    T, KVH = k.shape[1], k.shape[2]
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
    return (o, part_ml, part_acc) if keep_partials else o


flash_decode.launches = 0    # launches of the CUDA kernels by this wrapper
