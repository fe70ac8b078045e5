"""GQA/MQA attention for the global and local (sliding-window) paths:
reference oracle, the kernel-backed prefill, chunked-prefill and decode
attention over a KV cache (a local layer's cache is a ring of its window's
rows), and the vlm family's tanh-gated cross attention over vision tokens.

Shape conventions:
  x        (B, S, d_model)
  q        (B, S, H, D)
  k, v     (B, T, KVH, D)

On a CUDA tensor ``run_attention`` and ``chunk_attention`` run on the
flash-attention kernel and ``decode_attention`` on the flash-decode
kernel (``repro_torch.kernels.ops``); on a CPU tensor the same entry
points compute the same functions with the kernels' plain versions. The
caches are updated in place.

Under a ``ParallelContext`` with a mesh the tensors are DTensors: ``_shard``
is the reference's ``with_sharding_constraint`` helper (batch over the data
axes, heads over the model axis, axes that do not divide dropped), and the
kernel wrappers run on each rank's shard (``kernels/_mesh.py``). A cache
whose sequence is split over ranks is written by the rank that holds the
position (``write_kv``) and read by each rank over its own rows
(``kernels/decode_attention.py``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import AttentionConfig
from repro_torch.kernels import _mesh, ops
from repro_torch.kernels import rope_write as rw
from repro_torch.models.layers import Params, _summed, dense_init, linear, qk_norm_rope

NEG_INF = -1e30


# --------------------------------------------------------------------- #
#  Parameters                                                            #
# --------------------------------------------------------------------- #
def attn_init(gen: torch.Generator, a: AttentionConfig, d_model: int,
              d_kv_in: int = 0, dtype=torch.bfloat16) -> Params:
    """Self-attention when d_kv_in == 0, else cross-attention (keys and
    values projected from another width, e.g. the vision embeddings')."""
    d_kv_in = d_kv_in or d_model
    p = {
        "wq": dense_init(gen, d_model, a.n_heads * a.head_dim, dtype),
        "wk": dense_init(gen, d_kv_in, a.n_kv_heads * a.head_dim, dtype),
        "wv": dense_init(gen, d_kv_in, a.n_kv_heads * a.head_dim, dtype),
        "wo": dense_init(gen, a.n_heads * a.head_dim, d_model, dtype),
    }
    if a.qk_norm:
        p["q_norm"] = torch.ones((a.head_dim,), dtype=torch.float32, device=gen.device)
        p["k_norm"] = torch.ones((a.head_dim,), dtype=torch.float32, device=gen.device)
    return p


def cross_attn_init(gen: torch.Generator, a: AttentionConfig, d_model: int,
                    d_vision: int, dtype=torch.bfloat16) -> Params:
    p = attn_init(gen, a, d_model, d_kv_in=d_vision, dtype=dtype)
    p["gate"] = torch.zeros((), dtype=torch.float32, device=gen.device)  # tanh-gated residual
    return p


def _heads(y: torch.Tensor, H: int, D: int) -> torch.Tensor:
    """(..., H * D) as (..., H, D). Under a mesh the columns are split over
    ranks by the weight's placement; where that split does not fall on
    whole heads (gemma-2b's 8 query heads of 256 over a model axis of 16),
    the columns are gathered first, as the reference's constraint leaves
    such heads whole."""
    if _mesh.is_dtensor(y):
        mesh, last = y.device_mesh, y.ndim - 1
        split = [i for i, p in enumerate(y.placements) if _mesh.shard_dim(p, y.ndim) == last]
        if H % _mesh.coordinate(mesh, split)[1]:
            Replicate = _mesh._types()[2]
            y = _mesh.placed(y, mesh, [Replicate() if i in split else p
                                              for i, p in enumerate(y.placements)])
    return y.reshape(*y.shape[:-1], H, D)


def _split_dims(w: torch.Tensor, wq: torch.Tensor, a: AttentionConfig) -> list:
    """The mesh dims over which a KV projection ``w`` may split its columns
    (ROADMAP C21): the dims that split the query heads (``wq``'s columns)
    and leave ``w`` whole (KV heads that do not divide the model axis),
    where each rank's query heads read a strict subset of the KV heads
    (``kv_head_slice``, qwen3-1.7b's 16 query heads over 16 ranks read one
    of 8). None where every rank reads every KV head (one KV head) or runs
    every query head (query heads that do not divide the axis)."""
    if not (_mesh.is_dtensor(w) and _mesh.is_dtensor(wq)):
        return []
    from repro_torch.kernels.flash_attention import kv_head_slice
    dims = [i for i, (pq, pk) in enumerate(zip(wq.placements, w.placements))
            if _mesh.shard_dim(pq, 2) == 1 and _mesh.shard_dim(pk, 2) is None]
    n = _mesh.coordinate(w.device_mesh, dims)[1]
    if n == 1 or a.n_heads % n or w.shape[1] % n:
        return []
    heads = kv_head_slice(a.n_heads, a.n_kv_heads, 0, n)
    return dims if heads.stop - heads.start < a.n_kv_heads else []


def _columns(t, dims, split: bool):
    """t's last dim split over the mesh dims ``dims`` (``split``) or whole
    there, its other placements kept: Replicate -> Shard is a local slice."""
    Shard, Replicate = _mesh._types()[1:3]
    pl = [(Shard(t.ndim - 1) if split else Replicate()) if i in dims else p
          for i, p in enumerate(t.placements)]
    return _mesh.placed(t, t.device_mesh, pl)


class _WeightGradSplit(torch.autograd.Function):
    """``linear(x, w)`` whole on every rank, whose backward computes x's
    gradient whole and w's over the columns of each rank's block of
    ``dims`` (gathered afterwards): the reference's partitioned training
    step runs the KV projection and its input's gradient whole on each
    chip and splits only the weight's gradient over the ranks that share
    a batch."""

    @staticmethod
    def forward(ctx, x, w, dims):
        ctx.save_for_backward(x, w)
        ctx.dims = dims
        return linear(x, w)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        g = _summed(gy)
        gx = linear(g, w.t())
        g = _columns(g, ctx.dims, split=True)
        gw = linear(x.reshape(-1, x.shape[-1]).t(), g.reshape(-1, g.shape[-1]))
        return gx, _columns(gw, ctx.dims, split=False), None


def _kv_linear(x: torch.Tensor, w: torch.Tensor, wq: torch.Tensor,
               a: AttentionConfig) -> torch.Tensor:
    """``linear(x, w)`` of a KV projection. Where ``_split_dims`` allows,
    it is partitioned as the reference's compiler partitions it (ROADMAP
    C21): under a gradient the product runs whole and only w's gradient
    is split (``_WeightGradSplit``); without one, where x is larger than
    w (a prefill), each rank projects its block of w's columns and the
    KV-sized output is gathered back to the placement the whole product
    gives; a smaller x (a decode step, an engine's chunk) meets w whole."""
    dims = _split_dims(w, wq, a)
    if not dims:
        return linear(x, w)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _WeightGradSplit.apply(x, w, dims)
    if x.numel() <= w.numel():
        return linear(x, w)
    return _columns(_summed(linear(x, _columns(w, dims, split=True))), dims, split=False)


def _project(p: Params, a: AttentionConfig, x: torch.Tensor,
             kv_x: Optional[torch.Tensor] = None,
             kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The projections' heads: q (B, S, H, D) from x (B, S, d); k and v
    (B, T, KVH, D) from ``kv_x`` (B, T, d_kv_in), x itself when None, or
    ``kv``, those projections already made."""
    kv_x = x if kv_x is None else kv_x
    # under a mesh a projection whose contraction the ranks split (the
    # feature-split stream of tp2d_serve) is summed before its heads are read
    q = _heads(_summed(linear(x, p["wq"])), a.n_heads, a.head_dim)
    if kv is not None:
        return (q, *kv)
    k = _heads(_summed(_kv_linear(kv_x, p["wk"], p["wq"], a)), a.n_kv_heads, a.head_dim)
    v = _heads(_summed(_kv_linear(kv_x, p["wv"], p["wq"], a)), a.n_kv_heads, a.head_dim)
    return q, k, v


def _qk_norms(p: Params, a: AttentionConfig) -> dict:
    """The qk-norm's scales as keywords, None where the model has none."""
    return {"q_norm": p["q_norm"] if a.qk_norm else None,
            "k_norm": p["k_norm"] if a.qk_norm else None}


def project_qkv(p: Params, a: AttentionConfig, x: torch.Tensor,
                kv_x: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None, rope: bool = True,
                kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q from x (B, S, d); k and v from ``kv_x`` (B, T, d_kv_in), x itself
    when None, or ``kv``, those projections already made (B, T, KVH, D);
    q and k normed where the model has qk-norm, and rotated at
    ``positions`` (0.. S - 1 where None) unless ``rope`` is False."""
    q, k, v = _project(p, a, x, kv_x, kv)
    if rope and positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    q, k = qk_norm_rope(q, k, positions if rope else None, a.rope_theta, **_qk_norms(p, a))
    return q, k, v


# --------------------------------------------------------------------- #
#  Reference (oracle) attention                                          #
# --------------------------------------------------------------------- #
def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """GQA: repeat KV heads to the full head count."""
    KVH = k.shape[2]
    if KVH == n_heads:
        return k
    idx = torch.arange(n_heads, device=k.device) // (n_heads // KVH)
    return k[:, :, idx]


def reference_attention(q, k, v, kind: str = "causal", window: int = 0
                        ) -> torch.Tensor:
    """Plain attention over expanded KV heads: the oracle that the tests
    and the greedy full-forward generation use. No kernel on any device."""
    B, S, H, D = q.shape
    T = k.shape[1]
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) / math.sqrt(D)
    q_pos = torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(T, device=q.device)[None, :]
    if kind == "bidirectional":
        ok = torch.ones((S, T), dtype=torch.bool, device=q.device)
    elif kind == "causal":
        ok = k_pos <= q_pos
    elif kind == "local":
        ok = (k_pos <= q_pos) & (k_pos > q_pos - window)
    else:
        raise ValueError(kind)
    s = s + torch.where(ok, 0.0, NEG_INF)
    w = torch.softmax(s, dim=-1).to(v.dtype).float()
    o = torch.einsum("bhst,bthd->bshd", w, v.float())
    return o.to(q.dtype)


# --------------------------------------------------------------------- #
#  Sharding constraints                                                  #
# --------------------------------------------------------------------- #
def _shard(x, ctx, *spec):
    """The reference's ``with_sharding_constraint`` helper: a DTensor x
    redistributed to ``spec`` (one entry a dim: None, a mesh axis or a
    tuple of axes), axes that do not divide their dim dropped. A plain
    tensor, or ``ctx.mesh`` None, goes through as it is."""
    if ctx is None or getattr(ctx, "mesh", None) is None or not _mesh.is_dtensor(x):
        return x
    from repro_torch.parallel.sharding import sanitize, to_placements
    pl = tuple(to_placements(sanitize(spec, x.shape, ctx.mesh), ctx.mesh))
    return x if tuple(x.placements) == pl else x.redistribute(ctx.mesh, pl)


def _sharded(ctx) -> bool:
    return ctx is not None and getattr(ctx, "mesh", None) is not None


def _mesh_kw(ctx) -> dict:
    """``ctx`` as a keyword where a mesh is set: the one-device call keeps
    the signature ``run_attention(q, k, v, *, kind, window, softcap)``."""
    return {"ctx": ctx} if _sharded(ctx) else {}


def unshard_data(tree, ctx):
    """A layer's parameters whole over the data axes, each keeping its
    split over the model axis: the all-gather of the weights that the
    reference's compiler makes for the ``fsdp_tp`` recipe (ZeRO-3), made
    here per layer, inside its remat region, so the backward gathers
    again and reduce-scatters the gradients. Under
    ``ctx.feature_shard_decode`` (``tp2d_serve``) the 2-D weights stay
    where they are and the activations move instead. Plain tensors, and
    ``ctx.mesh`` None, go through as they are."""
    if not _sharded(ctx) or ctx.feature_shard_decode:
        return tree
    Replicate = _mesh._types()[2]
    names = ctx.mesh.mesh_dim_names

    def one(t):
        if not _mesh.is_dtensor(t):
            return t
        pl = tuple(Replicate() if n in ctx.data_axes else p
                   for n, p in zip(names, t.placements))
        return t if pl == tuple(t.placements) else t.redistribute(ctx.mesh, pl)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return None if t is None else one(t)
    return walk(tree)


# --------------------------------------------------------------------- #
#  Kernel-backed attention                                               #
# --------------------------------------------------------------------- #
def run_attention(q, k, v, *, kind: str = "causal", window: int = 0,
                  softcap: float = 0.0, ctx=None) -> torch.Tensor:
    """Full-sequence attention (prefill / forward) on the flash-attention
    kernel. Under a mesh q, k and v are constrained as the reference's
    ``flashref_attention`` constrains them: batch over the data axes, heads
    over the model axis."""
    if _sharded(ctx):
        da, ma = ctx.data_axes, ctx.model_axis
        q, k, v = (_shard(u, ctx, da, None, ma, None) for u in (q, k, v))
    return ops.flash_attention(q, k, v, kind=kind, window=window,
                               softcap=softcap)


def _align_to_cache(q, cache):
    """q (B, 1, H, D) placed to read a DTensor cache (B, T, KVH, D): its
    batch split where the cache's is, whole on the mesh dims that split the
    cache's sequence (a decode-sized gather), its heads as they are
    elsewhere."""
    if not _mesh.is_dtensor(cache):
        return q
    Shard, Replicate = _mesh._types()[1:3]
    qp = _mesh.placements(q, cache.device_mesh)
    want = []
    for a, b in zip(qp, cache.placements):
        db = _mesh.shard_dim(b, 4)
        want.append(Shard(0) if db == 0 else Replicate() if db == 1 else
                    (a if _mesh.shard_dim(a, 4) == 2 else Replicate()))
    if not _mesh.is_dtensor(q):
        raise ValueError("decode attention: a plain q over a DTensor cache")
    return q if tuple(qp) == tuple(want) else q.redistribute(cache.device_mesh, want)


def decode_attention(q, cache_k, cache_v, kv_len) -> torch.Tensor:
    """q: (B, 1, H, D); cache_{k,v}: (B, Smax, KVH, D); kv_len: () or (B,).
    One new token against the first ``kv_len[b]`` rows of each sequence's
    cache, on the flash-decode kernel."""
    return ops.flash_decode(_align_to_cache(q, cache_k), cache_k, cache_v, kv_len)


def chunk_attention(q, cache_k, cache_v, offsets: torch.Tensor,
                    softcap: float = 0.0) -> torch.Tensor:
    """Chunked-prefill attention: the queries of a chunk of c tokens at
    absolute positions pos0.. (padded to C >= c rows) over the first pos0 +
    c rows of the cache row ``slot``, on the flash-attention kernel, which
    reads ``offsets = [slot, pos0, c]`` from device memory. A padded query
    sees every valid key and its output is never read.
    q: (1, C, H, D); cache_{k,v}: (B_slots, Smax, KVH, D), a layer's cache.

    A DTensor cache (the serving recipes': slots over the data axes, the
    sequence over the model axis) is read through the slot's rows,
    gathered whole on every rank (``_slot_rows``, a layer's (Smax, KVH, D):
    about 2 MB for qwen3-1.7b at 1,025 positions), with the same kernel on
    each rank's query heads (ROADMAP C26)."""
    if _mesh.is_dtensor(cache_k):
        cache_k, cache_v = _slot_rows(cache_k, offsets), _slot_rows(cache_v, offsets)
        # the gathered rows are slot 0 of a one-slot cache; zeros_like keeps
        # the offsets on the device (a host copy would break a capture)
        offsets = torch.cat([torch.zeros_like(offsets[:1]), offsets[1:]])
    return ops.flash_attention(q, cache_k, cache_v, kind="causal",
                               softcap=softcap, offsets=offsets)


def _cache_blocks(cache):
    """A DTensor cache (B_slots, Smax, KVH, D): (the mesh dims that split
    its slots, those that split its sequence, this rank's index along each
    set and their sizes). Nothing else may be split."""
    mesh = cache.device_mesh
    _mesh.check("kv cache", "cache", cache, mesh, (0, 1))
    slots = [i for i, p in enumerate(cache.placements) if _mesh.shard_dim(p, 4) == 0]
    seq = [i for i, p in enumerate(cache.placements) if _mesh.shard_dim(p, 4) == 1]
    return slots, seq, _mesh.coordinate(mesh, slots), _mesh.coordinate(mesh, seq)


def _local_slot(offsets, cb: int, Bl: int):
    """This rank's row (1,) of the slot ``offsets[0]`` in its block of
    ``Bl`` slots (clamped into it), and whether the block holds it (1,)."""
    s = offsets[:1] - cb * Bl
    return torch.clamp(s, 0, Bl - 1), (s >= 0) & (s < Bl)


def _slot_rows(cache, offsets):
    """The rows of slot ``offsets[0]`` of a DTensor cache, (1, Smax, KVH,
    D), whole on every rank: the rank that holds the slot contributes its
    block of the sequence and the others zeros (a sum over the slots' mesh
    dims, exact), gathered over the sequence's."""
    Shard, Replicate, Partial = _mesh._types()[1:4]
    mesh = cache.device_mesh
    slots, seq, (cb, nb), _ = _cache_blocks(cache)
    Bl = cache.shape[0] // nb

    def run(c, off):
        s, here = _local_slot(off, cb, Bl)
        return torch.where(here[:, None, None, None], c.index_select(0, s), 0)
    pl = [Partial() if i in slots else Shard(1) if i in seq else Replicate()
          for i in range(mesh.ndim)]
    rows = _mesh.local(run, mesh, (cache, offsets), pl)
    return _mesh.placed(rows, mesh, [Replicate()] * mesh.ndim)


def _write_chunk_sharded(cache, new, offsets) -> None:
    """A chunk's keys or values ``new`` (1, C, KVH, D) into a DTensor cache
    (B_slots, Smax, KVH, D) at slot ``offsets[0]``, positions ``offsets[1]
    ..`` for the ``offsets[2]`` real rows, in place: ``new`` whole on every
    rank (chunk-sized), and the rank that holds the slot rewrites the
    positions of its block of the sequence that the chunk covers, leaving
    its other rows as they are. Everything is read on the device. The
    padding's rows are not written (the one-device extend sends them to the
    trash position, which no valid read covers)."""
    Replicate = _mesh._types()[2]
    mesh = cache.device_mesh
    _, _, (cb, nb), (cs, ns) = _cache_blocks(cache)
    Bl, Tl = cache.shape[0] // nb, cache.shape[1] // ns
    if not _mesh.is_dtensor(new):
        raise ValueError("extend: plain keys or values for a DTensor cache")
    new = _mesh.placed(new, mesh, [Replicate()] * mesh.ndim)

    def run(c, n, off):
        s, here = _local_slot(off, cb, Bl)
        src = cs * Tl + torch.arange(Tl, device=c.device) - off[1]
        ok = here & (src >= 0) & (src < off[2])
        rows = n[0].index_select(0, torch.clamp(src, 0, n.shape[1] - 1)).to(c.dtype)
        c.index_copy_(0, s, torch.where(ok[:, None, None], rows, c.index_select(0, s)[0])[None])
    _mesh.local(run, mesh, (cache, new, offsets), None)


def self_attention_block(p: Params, a: AttentionConfig, x: torch.Tensor, *,
                         kind: str,
                         positions: Optional[torch.Tensor] = None, ctx=None
                         ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full self-attn block (proj -> attn -> out proj). Returns (out, (k, v))
    so prefill can populate the cache."""
    q, k, v = project_qkv(p, a, x, positions=positions)
    o = run_attention(q, k, v, kind=kind, window=a.local_window,
                      softcap=a.softcap, **_mesh_kw(ctx))
    B, S = x.shape[:2]
    return linear(_mesh.grad_placed(o.reshape(B, S, -1)), p["wo"]), (k, v)


def cross_attention_block(p: Params, a: AttentionConfig, x: torch.Tensor,
                          vision: torch.Tensor,
                          kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                          ctx=None) -> torch.Tensor:
    """Tanh-gated cross attention of x (B, S, d) over precomputed vision
    tokens (B, T, d_vision): keys and values projected from ``vision``, no
    RoPE, bidirectional attention on the flash-attention kernel, and the
    output ``tanh(gate)`` (f32, cast to the output's type) times ``o @ wo``.
    The reference routes this call to its chunked jnp attention even when
    its kernel is asked for (``attn_impl="pallas"``); that computes the same
    function, and the port runs it on the kernel, as every attention.
    ``kv``: ``vision``'s k and v projections (B, T, KVH, D) where the
    caller has made them already (the prefill keeps them as its cache)."""
    q, k, v = project_qkv(p, a, x, kv_x=vision, rope=False, kv=kv)
    o = run_attention(q, k, v, kind="bidirectional", **_mesh_kw(ctx))
    B, S = x.shape[:2]
    out = linear(_mesh.grad_placed(o.reshape(B, S, -1)), p["wo"])
    return torch.tanh(p["gate"]).to(out.dtype) * out


def chunk_rows(offsets: torch.Tensor, C: int, smax: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The positions (1, C) of a chunk's C rows, ``pos0 + i``, and the flat
    cache rows (C,) that take their keys and values: row ``pos0 + i`` of
    slot ``slot`` for the c real tokens, the trash position ``smax - 1`` for
    the padding (so that a chunk whose bucket reaches past the cache writes
    nothing out of bounds). offsets: ``[slot, pos0, c]`` on the device."""
    i = torch.arange(C, device=offsets.device)
    pos = offsets[1] + i
    rows = offsets[0] * smax + torch.where(i < offsets[2], pos, smax - 1)
    return pos[None, :], rows


def extend_self_attention(p: Params, a: AttentionConfig, x: torch.Tensor,
                          cache_k, cache_v, offsets: torch.Tensor,
                          positions: torch.Tensor, rows: torch.Tensor
                          ) -> torch.Tensor:
    """Chunked-prefill step for one self-attn block: project the chunk's C
    rows (x (1, C, d)), write their k/v into the cache rows ``rows`` in
    place, attend over the valid prefix of the slot. cache_{k,v}: (B_slots,
    Smax, KVH, D), a layer's cache; offsets, positions and rows as
    ``chunk_rows`` gives them. The norm, RoPE and the writes are one
    ``rope_write`` launch on the card. A DTensor cache takes the eager
    chain, written rank by rank at ``offsets`` (``_write_chunk_sharded``)
    and read through the slot's rows (``chunk_attention``)."""
    B, C = x.shape[:2]
    q, _ = rw.rope_write(*_project(p, a, x), cache_k, cache_v, positions, rows,
                         offsets=offsets, theta=a.rope_theta, **_qk_norms(p, a))
    o = chunk_attention(q, cache_k, cache_v, offsets, softcap=a.softcap)
    return linear(o.reshape(B, C, -1), p["wo"])


def write_kv(cache: torch.Tensor, new: torch.Tensor, idx: torch.Tensor) -> None:
    """Write (B,1,KVH,D) into (B,Smax,KVH,D) at position `idx` ((B,) tensor),
    in place. A DTensor cache is written rank by rank (``_write_kv_sharded``)."""
    if _mesh.is_dtensor(cache):
        return _write_kv_sharded(cache, new, idx)
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, idx] = new[:, 0].to(cache.dtype)


def _write_kv_sharded(cache, new, idx) -> None:
    """``write_kv`` into a DTensor cache whose batch may be split over some
    mesh dims and its sequence over others (the serving recipes' cache):
    the new rows are placed as the cache's batch (whole elsewhere, a
    decode-sized gather) and each rank writes the positions that fall in
    its block of the sequence, leaving its other rows as they are. ``idx``
    is the whole batch's positions, a plain (B,) tensor."""
    Shard, Replicate = _mesh._types()[1:3]
    mesh, cp = cache.device_mesh, cache.placements
    name = "write_kv"
    _mesh.check(name, "cache", cache, mesh, (0, 1))
    if _mesh.is_dtensor(idx):
        _mesh.refuse(name, "idx", idx.placements, "positions come whole")
    batch = [i for i, p in enumerate(cp) if _mesh.shard_dim(p, 4) == 0]
    seq = [i for i, p in enumerate(cp) if _mesh.shard_dim(p, 4) == 1]
    want = [Shard(0) if i in batch else Replicate() for i in range(mesh.ndim)]
    if not _mesh.is_dtensor(new):
        raise ValueError(f"{name}: plain new rows for a DTensor cache")
    if tuple(new.placements) != tuple(want):
        new = new.redistribute(mesh, want)
    cb, nb = _mesh.coordinate(mesh, batch)
    cs, ns = _mesh.coordinate(mesh, seq)
    Tl = cache.shape[1] // ns

    def run(c, n, i):
        i = i.reshape(nb, -1)[cb] - cs * Tl
        ok = (i >= 0) & (i < Tl)
        i = torch.clamp(i, 0, Tl - 1)
        rows = torch.arange(c.shape[0], device=c.device)
        c[rows, i] = torch.where(ok[:, None, None], n[:, 0].to(c.dtype), c[rows, i])
    _mesh.local(run, mesh, (cache, new, idx), None)


def decode_self_attention(p: Params, a: AttentionConfig, x: torch.Tensor,
                          cache_k, cache_v, pos, *, kind: str = "causal") -> torch.Tensor:
    """One-token decode step for a self-attention block.

    x: (B, 1, d); cache_{k,v}: (B, Smax, KVH, D), updated in place; pos: int,
    () or (B,) — absolute position of the new token. A ``"local"`` layer's
    cache is a ring of Smax rows (its window): the new row goes to slot
    ``pos % Smax``, and every warm slot is valid, so the causal decode over
    ``min(pos + 1, Smax)`` rows is the window's attention. The norm, RoPE,
    the writes and those lengths are one ``rope_write`` launch on the card;
    a DTensor cache takes the eager chain, written rank by rank
    (``write_kv``). Returns the block's output."""
    B = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device).reshape(-1).expand(B)
    q, kv_len = rw.rope_write(*_project(p, a, x), cache_k, cache_v, pos[:, None],
                              theta=a.rope_theta, ring=kind == "local", **_qk_norms(p, a))
    o = decode_attention(q, cache_k, cache_v, kv_len)
    return linear(o.reshape(B, 1, -1), p["wo"])
