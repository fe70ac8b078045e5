"""Attention forward: the wrapper of the CUDA kernel
``csrc/flash_attention.cu`` and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention_bhsd``). The kernel keeps scores and weights out of
device memory: one block per (batch, head, query tile) loops over the KV
tiles with ``m``, ``l`` and the output tile in registers; q, k, v and o are
used in the model's layouts through strides, so a slot's slice of the KV
cache is read in place. bf16 runs on the tensor cores (``mma.sync``), f32
queries on the FP32 pipes (the reference's f32 tolerance is beyond bf16 and
TF32 products). ``split_plan`` decides from the shapes alone which body
runs, its query tile, and whether the keys are split over blocks, whose
partial ``(m, l, acc)`` a second kernel merges as ``flash_decode`` does.
At head_dim 256 the bf16 body walks 32-key tiles and reads Q from shared
memory at each k-step (its output tile takes 128 registers a thread); the
f32 body is not built there (ptxas spills it) and f32 queries at head_dim
256 are refused. Head_dim 80 (hubert-xlarge) runs as it is, in both
bodies: its 160-byte rows have a shared-memory swizzle of their own, and
nothing is padded to 128.

``q_offset`` is added to the query position in the causal / local mask
(``k_pos <= q_pos + q_offset``). At 0 this is the reference kernel; at
``pos0`` the S queries are a prefill chunk at absolute positions
``pos0 .. pos0 + S - 1`` over the first ``pos0 + S`` rows of a cache.

``offsets`` is the same chunk in a step captured into a CUDA graph, where no
host value may change between replays: a device int64 tensor ``[slot,
pos0, c]``. Batch b of q then reads row ``slot + b`` of k and v (the whole
cache), the mask takes ``q_offset = pos0``, and only the first ``T = pos0 +
c`` keys are valid; q is the chunk padded to its bucket (rows past c sit at
positions >= T, see every valid key, and are never read). The split of the
keys is planned from the cache's length and fixed; the kernels work out
each split's keys from T.

Where a gradient is wanted the wrapper runs the kernel inside
``_grad.KernelFunction``: the backward is the plain version's.

Over DTensors (``_mesh``) each rank attends with its own shard: the batch
and the heads may be split across ranks, the sequence and head_dim may not.
Where a mesh dim splits q's heads and leaves k and v whole (KV heads that
do not divide the model axis, which the reference's sanitised constraint
leaves replicated), each rank slices the KV heads its query heads read,
as the reference's expansion of k and v to every query head followed by
its head-sharded constraint gives each device.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import _build, _grad, _mesh

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 80, 128, 256)   # head sizes the kernel is built for
KINDS = {"causal": 0, "local": 1, "bidirectional": 2}   # csrc/common.cuh
TILE = 64                        # keys a tile (FA_BN), queries a tile of the bf16 body
MAX_SPLITS = 4                   # most pieces the keys of a query tile are split into
N_SM = 132                       # the H100's SMs: what a plan has to fill
# blocks of the bf16 body an SM holds at every head size built: its
# registers allow two (at most 255 a thread: two blocks of 128 threads fill
# the SM's 65,536), and so does its shared memory, 80 KB at head_dim 128 and
# 96 KB at 256, where a tile is 32 keys for that reason
BLOCKS_PER_SM = 2


def split_plan(B: int, S: int, H: int, T: int, q_dtype: torch.dtype,
               n_sm: int = N_SM, kv_splits: int = 0) -> dict:
    """Which body runs and on what grid, from the shapes alone.

    bf16: the tensor-core body, 64 queries a block. When B x H x S/64
    blocks leave some of the card's ``BLOCKS_PER_SM`` x ``n_sm`` places
    empty (a prefill chunk of one sequence), the keys are split into up to
    ``MAX_SPLITS`` pieces of whole tiles, at least two tiles each, so that
    blocks x splits fill them and no block walks all the keys; the partials
    are merged by a second kernel. ``kv_splits`` > 0 asks for that many pieces
    instead (fewer come back where the keys run out). f32 queries: the FMA
    body, 64 queries a block, or 32 when that leaves SMs idle, never
    split (built up to head_dim 128). Returns ``{"body", "bm", "kv_splits",
    "chunk"}``: the keys ``[s * chunk, (s + 1) * chunk)`` of split s cover
    ``[0, T)`` once."""
    n_tiles = max(1, -(-T // TILE))
    if q_dtype == torch.float32:
        bm = TILE if -(-S // TILE) * H * B >= n_sm else 32
        return {"body": "fma_f32", "bm": bm, "kv_splits": 1, "chunk": n_tiles * TILE}
    blocks = max(1, -(-S // TILE) * H * B)
    places = BLOCKS_PER_SM * n_sm
    want = kv_splits or (1 if blocks >= places
                         else min(MAX_SPLITS, -(-places // blocks), n_tiles // 2))
    per = -(-n_tiles // max(1, want))                 # tiles a split
    return {"body": "mma_bf16", "bm": TILE, "kv_splits": -(-n_tiles // per),
            "chunk": per * TILE}


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kind: str = "causal", window: int = 0,
                          q_offset: int = 0, offsets=None) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, T, KVH, D). Scores and softmax in f32,
    masked scores set to -1e30, the weights cast to ``v.dtype`` before the
    weighted sum, which comes out in ``v.dtype``. Returns (B, S, H, D) in
    ``q.dtype``. With ``offsets`` (a tensor ``[slot, pos0, c]``) k and v are
    the whole cache and the values are read on the device, as the kernel
    reads them: rows ``slot ..`` of k and v, ``q_offset = pos0``, keys at
    ``pos0 + c`` and beyond masked."""
    if kind not in KINDS:
        raise ValueError(f"unknown attention kind {kind!r}")
    B, S, H, D = q.shape
    T, KVH = k.shape[1], k.shape[2]
    if offsets is not None:
        rows = offsets[0] + torch.arange(B, device=q.device)
        k, v = k.index_select(0, rows), v.index_select(0, rows)
        q_offset = offsets[1]
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
    if offsets is not None:
        ok = ok & (k_pos < offsets[1] + offsets[2])
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1).to(v.dtype).float()
    o = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return o.reshape(B, S, H, D).to(v.dtype).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kind: str = "causal", window: int = 0,
                    q_offset: int = 0, kv_splits: int = 0,
                    offsets=None) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, T, KVH, D), possibly strided views, or
    with ``offsets`` (a device int64 tensor ``[slot, pos0, c]``, q_offset 0)
    the whole cache, of which rows ``slot .. slot + B - 1`` are read. A
    tensor on the CPU takes the plain version, and so does one on ``meta``
    (shapes only: the dry run's count); a CUDA tensor launches the
    kernel or raises. ``kv_splits`` overrides the plan's split of the keys
    (bf16 only; 0: the plan's own). Where q, k or v requires grad (and grad
    mode is on), the three get the plain version's gradients; the
    ``offsets`` form, the engine's extend step, then raises."""
    if _mesh.any_dtensor(q, k, v):
        return _sharded(q, k, v, kind, window, q_offset, kv_splits, offsets)
    if _grad.needs_grad(q, k, v):
        if offsets is not None:
            raise RuntimeError("flash_attention with offsets (the engine's extend "
                               "step) has no gradient: call it under torch.no_grad()")
        return _grad.KernelFunction.apply(
            lambda q, k, v: _forward(q, k, v, kind, window, q_offset, kv_splits),
            lambda q, k, v: flash_attention_plain(q, k, v, kind, window, q_offset),
            q, k, v)
    return _forward(q, k, v, kind, window, q_offset, kv_splits, offsets)


def kv_head_slice(H: int, KVH: int, c: int, n: int) -> slice:
    """The KV heads that query heads ``[c * H / n, (c + 1) * H / n)`` read
    (query head h reads KV head h // (H / KVH)): whole groups, or the one
    KV head a group of query heads shares."""
    G, Hl = H // KVH, H // n
    if Hl % G and G % Hl:
        raise ValueError(f"flash_attention: {H} query heads split {n} ways do "
                         f"not tile the groups of {G} over {KVH} KV heads")
    lo = c * Hl // G
    return slice(lo, lo + max(1, Hl // G))


def _sharded(q, k, v, kind, window, q_offset, kv_splits, offsets):
    name = "flash_attention"
    if offsets is not None:
        raise ValueError(f"{name}: the offsets form (the engine's extend step) "
                         "takes no DTensor")
    mesh = _mesh.mesh_of(q, k, v)
    qp = _mesh.check(name, "q", q, mesh, (0, 2))
    kp = _mesh.check(name, "k", k, mesh, (0, 2))
    if _mesh.placements(v, mesh) != kp:
        _mesh.refuse(name, "v", _mesh.placements(v, mesh), f"k is placed {kp}")
    head_dims = []        # mesh dims that split q's heads and leave k's whole
    for i, (a, b) in enumerate(zip(qp, kp)):
        da, db = _mesh.shard_dim(a, 4), _mesh.shard_dim(b, 4)
        if da == 2 and db is None:
            head_dims.append(i)
        elif da != db:
            _mesh.refuse(name, "q and k", (qp, kp),
                         f"mesh dim {i} splits q's dim {da} and k's {db}")
    if head_dims and any(_mesh.shard_dim(b, 4) == 2 for b in kp):
        _mesh.refuse(name, "q and k", (qp, kp), "k's heads are split on other mesh dims")
    heads = (kv_head_slice(q.shape[2], k.shape[2], *_mesh.coordinate(mesh, head_dims))
             if head_dims else slice(None))

    def run(q, k, v):
        return flash_attention(q, k[:, :, heads], v[:, :, heads], kind, window,
                               q_offset, kv_splits)
    return _mesh.local(run, mesh, (q, k, v), list(qp))


def _forward(q, k, v, kind, window, q_offset, kv_splits, offsets=None):
    if q.device.type in ("cpu", "meta"):
        return flash_attention_plain(q, k, v, kind, window, q_offset, offsets)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if kind not in KINDS:
        raise ValueError(f"unknown attention kind {kind!r}")
    B, S, H, D = q.shape
    T, KVH = k.shape[1], k.shape[2]
    if offsets is not None:
        if (offsets.shape != (3,) or offsets.dtype != torch.int64
                or offsets.device != q.device or q_offset != 0):
            raise ValueError("flash_attention: offsets must be a (3,) int64 tensor "
                             "[slot, pos0, c] on q's device, with q_offset 0")
        offsets = offsets.contiguous()
    elif k.shape[0] != B:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} do not fit")
    if k.shape[1:] != (T, KVH, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} do not fit")
    _build.check_dtypes("flash_attention", q, k, v)
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not in {HEAD_DIMS}")
    if D > 128 and q.dtype == torch.float32:
        raise ValueError(f"flash_attention: f32 queries at head_dim {D} are not built "
                         "(the f32 body spills registers there); pass bf16")
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
    plan = split_plan(B, S, H, T, q.dtype, _sm_count(q.device), kv_splits)
    n_splits = plan["kv_splits"]
    part_ml = part_acc = None
    if n_splits > 1:
        s_pad = -(-S // TILE) * TILE
        part_ml = torch.empty((2, B, H, n_splits, s_pad), dtype=torch.float32,
                              device=q.device)
        part_acc = torch.empty((B, H, n_splits, s_pad, D), dtype=torch.float32,
                               device=q.device)
    rc = _build.load().rt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        *((part_ml[0].data_ptr(), part_ml[1].data_ptr(), part_acc.data_ptr())
          if n_splits > 1 else (None, None, None)),
        None if offsets is None else offsets.data_ptr(),
        B, S, T, H, KVH, D,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        o.stride(0), o.stride(1), o.stride(2),
        KINDS[kind], int(window), int(q_offset),
        _build.DTYPE_CODES[q.dtype], _build.DTYPE_CODES[k.dtype],
        plan["bm"], plan["chunk"], n_splits, _build.stream_ptr())
    _build.check_launch(rc, f"flash_attention q{tuple(q.shape)} k{tuple(k.shape)}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0     # launches of the CUDA kernel by this wrapper
