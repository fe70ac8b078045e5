"""Mixture-of-Experts FFN with sort-based grouped dispatch: the twin of
``src/repro/models/moe.py``.

Each token is routed to its top-k experts by an f32 router. The (token,
expert) assignments are sorted by expert with a stable sort, as
``jnp.argsort`` sorts; each expert keeps its first ``cap`` tokens in a
capacity buffer ``(E, cap, d)`` with one trash row beyond it for the
dropped ones; the expert FFNs run over each expert's kept rows of the
buffer (``kernels/moe_experts.py``: a CUDA kernel on the card, three
batched products over every row on the CPU); and each token sums its kept
contributions, weighted by its gates.

Two entry points share that math, as in the reference:
  ``moe_ffn_local``  — single-device path (E_local = E);
  ``moe_ffn``        — expert parallelism over a ``ParallelContext``: each
                       rank of the model axis routes every token of its
                       data shard, dispatches only to its ``E / n_model``
                       local experts, and the partial outputs are summed
                       with an ``all_reduce`` over the model axis (no
                       token all-to-all). Over DTensors (the sharded
                       forward) the same function runs under ``local_map``
                       on each rank's tokens and experts, and the partial
                       outputs are left ``Partial`` over the model axis
                       for DTensor to sum where they are next read.

Nothing here waits for the host or takes a shape from the data (no
``.item()``, no ``nonzero``, no boolean-mask indexing): the engine captures
these bodies into CUDA graphs.

**The combine** (``_combine``). The reference adds each token's
contributions with a scatter-add over the sorted assignments
(``out.at[tok].add``), which XLA runs in update order: ascending expert id
within a token, each add rounded to the output type. A scatter-add on the
card accumulates with atomics, whose order changes from run to run. Here
the k contributions of each token are brought back to a ``(T, k, d)``
layout by the inverse of the sort and added in that same fixed order.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import _mesh, moe_experts
from repro_torch.models.layers import Params, _normal, dense_init, mlp


class ParallelContext(NamedTuple):
    """How model-internal collectives see the mesh (a ``DeviceMesh`` with
    dim names). mesh=None => local."""
    mesh: Optional[object] = None
    data_axes: Tuple[str, ...] = ()
    model_axis: Optional[str] = None
    # tp2d decode: weights are (d@data, ff@model); activations hop between
    # batch-sharded (attention/cache) and feature-sharded (MLP) layouts —
    # decode-sized reshards instead of weight-sized all-gathers
    feature_shard_decode: bool = False

    def _size(self, axis: str) -> int:
        return int(self.mesh.shape[self.mesh.mesh_dim_names.index(axis)])

    @property
    def n_model_shards(self) -> int:
        if self.mesh is None or self.model_axis is None:
            return 1
        return self._size(self.model_axis)

    @property
    def n_data_shards(self) -> int:
        if self.mesh is None:
            return 1
        return math.prod(self._size(a) for a in self.data_axes) or 1


LOCAL_CTX = ParallelContext()


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16) -> Params:
    """The router in f32, the experts' ``w_gate`` / ``w_up`` (E, d, f) and
    ``w_down`` (E, f, d), and the shared experts' MLP if the config has any."""
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff_expert, m.n_experts
    scale = 1.0 / math.sqrt(d)
    p = {"router": _normal(gen, (d, E), scale, torch.float32),
         "w_gate": _normal(gen, (E, d, f), scale, dtype),
         "w_up": _normal(gen, (E, d, f), scale, dtype),
         "w_down": _normal(gen, (E, f, d), 1.0 / math.sqrt(f), dtype)}
    if m.n_shared_experts:
        fs = m.n_shared_experts * f
        p["shared"] = {"w_gate": dense_init(gen, d, fs, dtype),
                       "w_up": dense_init(gen, d, fs, dtype),
                       "w_down": dense_init(gen, fs, d, dtype)}
    return p


def capacity(n_tokens_local: int, cfg: ModelConfig) -> int:
    """Tokens an expert keeps of ``n_tokens_local``: a multiple of 8, at least 8."""
    m = cfg.moe
    c = int(math.ceil(n_tokens_local * m.top_k * m.capacity_factor / m.n_experts))
    return max(8, -(-c // 8) * 8)


@functools.lru_cache(maxsize=None)
def capacity_table(n_rows: int, cfg: ModelConfig, device: torch.device) -> torch.Tensor:
    """``capacity(i, cfg)`` for i in 0 .. n_rows, an int64 tensor on
    ``device`` indexed there by a token count that lies on the device. Made
    once per (rows, config, device), at a captured step's warm-up, so the
    capture reads it and copies nothing from the host."""
    return torch.tensor([capacity(i, cfg) for i in range(n_rows + 1)], device=device)


# --------------------------------------------------------------------- #
#  Routing, dispatch, expert products, combine                           #
# --------------------------------------------------------------------- #
LOADS: Optional[list] = None
"""Where set (``loads_kept``), each dispatch appends its experts' routed and
kept row counts, a pair of (E,) tensors on the device."""


@contextlib.contextmanager
def loads_kept():
    """A list that receives each dispatch's ``(routed, kept)`` while the
    block runs: per expert, the rows routed to it (a padded chunk's padding
    goes to none; a decode step's idle slots, which take capacity, do) and
    the first ``cap`` of them, which it keeps. They are the
    dispatch's own tensors, so inside a CUDA graph's capture the list holds
    the graph's buffers, which each replay rewrites, at no cost to it."""
    global LOADS
    saved, LOADS = LOADS, []
    try:
        yield LOADS
    finally:
        LOADS = saved


def _route(router: torch.Tensor, x_flat: torch.Tensor, cfg: ModelConfig
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x_flat (T, d) -> gates (T, k) f32 renormalised over the top k, ids
    (T, k) in descending gate order, and the Switch load-balance loss
    ``E * sum_e f_e * p_e`` over the T rows. The router's product is f32:
    on the card it must not run in TF32 (PyTorch's default leaves
    ``torch.backends.cuda.matmul.allow_tf32`` off), or routing moves."""
    m = cfg.moe
    logits = x_flat.float() @ router
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.topk(probs, m.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=0)
    # the one-hot of the top k summed over k: the k ids of a row differ
    ce = torch.zeros_like(probs).scatter_(1, ids, 1.0).mean(dim=0)
    return gates, ids, m.n_experts * torch.sum(me * ce)


def _dispatch_compute_combine(x_flat, gates, ids, wg, wu, wd, cap: int,
                              act: str = "silu",
                              n_real: Optional[torch.Tensor] = None,
                              cap_real: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x_flat (T, d); gates / ids (T, k); expert weights (E, d, f) and (E,
    f, d). Returns (T, d): each token's kept contributions, gate-weighted.

    ``cap`` sizes the buffer; the expert products run over each expert's
    kept rows (``kernels/moe_experts.py``). Where only the first ``n_real``
    rows are tokens (a chunk padded to its bucket; ``n_real`` a (1,) tensor
    on the device), the other rows' assignments go to the drop bucket, and
    an expert keeps ``cap_real`` <= ``cap`` tokens, the capacity of
    ``n_real``: what the reference's dispatch of exactly ``n_real`` tokens
    keeps."""
    T, d = x_flat.shape
    E, k = wg.shape[0], ids.shape[1]
    dev = x_flat.device
    flat_ids = ids.reshape(-1)                                  # (T*k,)
    sort_key = flat_ids
    if n_real is not None:
        row = torch.arange(T * k, device=dev) // k
        sort_key = torch.where(row < n_real, flat_ids, E)       # drop bucket last
    sorted_ids, order = torch.sort(sort_key, stable=True)
    # position within each expert group
    starts = torch.searchsorted(sorted_ids, torch.arange(E + 1, device=dev))
    pos = torch.arange(T * k, device=dev) - starts[sorted_ids]
    keep = (sorted_ids < E) & (pos < (cap if cap_real is None else cap_real))
    slot = torch.where(keep, sorted_ids * cap + pos, E * cap)
    tok = order // k                                            # source token
    # the dropped rows all write zeros to the trash row E * cap
    buf = x_flat.new_zeros((E * cap + 1, d))
    buf.index_copy_(0, slot, torch.where(keep[:, None], x_flat.index_select(0, tok), 0))
    # each expert's kept rows, on the device: the expert products compute
    # only those (``kernels/moe_experts.py``; on the CPU all cap rows)
    routed = starts[1:] - starts[:-1]
    count = torch.clamp(routed, max=cap) if cap_real is None else torch.minimum(routed, cap_real)
    if LOADS is not None:
        LOADS.append((routed, count))
    out_e = moe_experts.moe_experts(buf[:-1].view(E, cap, d), count.to(torch.int32),
                                    wg, wu, wd, act).view(E * cap, d)
    # a dropped assignment reads a row the kernel left unwritten: masked
    # before the gate multiplies it, so neither its value nor the gate's
    # gradient (0 x that row) can carry a NaN
    contrib = torch.where(keep[:, None],
                          out_e.index_select(0, torch.where(keep, slot, E * cap - 1)), 0)
    gate = gates.reshape(-1).index_select(0, order)[:, None].to(contrib.dtype)
    return _combine(contrib * gate, order, ids)


def _combine(contrib: torch.Tensor, order: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """contrib (T*k, d): the assignments' contributions in sorted order
    (``order`` the stable sort's permutation of the flat (T, k) ids) ->
    (T, d). Each token's k contributions go back to a (T, k, d) layout by
    the inverse of the sort and are added one at a time in ascending expert
    id, each add rounded to contrib's type: the order of the reference's
    scatter-add over the sorted assignments, and the same on every run."""
    T, k = ids.shape
    d = contrib.shape[1]
    by_choice = torch.empty_like(contrib).index_copy_(0, order, contrib).view(T, k, d)
    by_expert = by_choice.gather(1, torch.argsort(ids, dim=1)[..., None].expand(T, k, d))
    out = by_expert[:, 0]
    for j in range(1, k):
        out = out + by_expert[:, j]
    return out


def moe_ffn_local(p: Params, cfg: ModelConfig, x: torch.Tensor,
                  n_real: Optional[torch.Tensor] = None):
    """x (B, S, d) -> (out (B, S, d), aux). With ``n_real`` (a (1,) integer
    tensor on the device) only the first ``n_real`` of the B * S rows are
    tokens (the engine's extend step pads a chunk to its bucket): the
    padding takes no expert's capacity and the capacity is that of
    ``n_real`` tokens, so the real rows get what the reference's call on
    exactly those tokens gives; the padding's rows and aux (over every row)
    are not read."""
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    gates, ids, aux = _route(p["router"], xf, cfg)
    cap = capacity(xf.shape[0], cfg)
    cap_real = (None if n_real is None
                else capacity_table(xf.shape[0], cfg, xf.device).index_select(0, n_real))
    out = _dispatch_compute_combine(xf, gates, ids, p["w_gate"], p["w_up"], p["w_down"],
                                    cap, cfg.act if cfg.act != "geglu" else "gelu",
                                    n_real, cap_real)
    if cfg.moe.n_shared_experts:       # one MLP, silu whatever cfg.act is, as in the reference
        out = out + mlp(p["shared"], xf, "silu")
    return out.reshape(B, S, d), aux


EXPERT_KEYS = ("w_gate", "w_up", "w_down")


def _expert_block(cfg: ModelConfig, ctx: ParallelContext) -> Tuple[int, int]:
    """This rank's experts ``[lo, lo + n_local)``: its block of the model axis."""
    E, n_model = cfg.moe.n_experts, ctx.n_model_shards
    assert E % n_model == 0, f"experts {E} not divisible by model axis {n_model}"
    n_local = E // n_model
    return ctx.mesh.get_local_rank(ctx.model_axis) * n_local, n_local


def _rank_experts(xf, router, w, cfg: ModelConfig, lo: int,
                  n_real: Optional[torch.Tensor] = None):
    """One rank's part of expert parallelism: xf (T, d), its tokens, all
    routed; ``w`` its experts' (w_gate, w_up, w_down), which are experts
    ``lo ..``. The other ranks' experts go to the drop bucket; each local
    expert keeps the capacity of the T tokens, or with ``n_real`` (see
    ``moe_ffn_local``) routes only the first ``n_real`` rows and keeps the
    capacity of ``n_real`` tokens. Returns (this rank's partial output (T,
    d), its tokens' aux)."""
    n_local = w[0].shape[0]
    gates, ids, aux = _route(router, xf, cfg)
    local_ids = torch.where((ids >= lo) & (ids < lo + n_local), ids - lo, n_local)
    cap_real = (None if n_real is None
                else capacity_table(xf.shape[0], cfg, xf.device).index_select(0, n_real))
    out = _dispatch_compute_combine(xf, gates, local_ids, *w, capacity(xf.shape[0], cfg),
                                    cfg.act if cfg.act != "geglu" else "gelu",
                                    n_real, cap_real)
    return out, aux


def moe_ffn(p: Params, cfg: ModelConfig, x: torch.Tensor, ctx: ParallelContext,
            n_real: Optional[torch.Tensor] = None):
    """Expert parallelism over ``ctx.model_axis``. x (B, S, d): this rank's
    data shard; the experts' weights whole (E, ...), of which this rank
    reads its slice. Every rank of the model axis holds the same
    x, routes all its tokens, and computes the contributions of its local
    experts ``[idx * n_local, (idx + 1) * n_local)`` with the capacity of
    its B * S tokens; the partial outputs are summed over the model axis
    (``all_reduce``, differentiable), the shared experts added, and aux
    averaged over the model and data axes. With ``ctx.mesh`` None, or one
    model shard, this is ``moe_ffn_local``. A DTensor x takes
    ``_moe_ffn_sharded``. ``n_real``: as in ``moe_ffn_local`` (the engine's
    padded chunk: only its real rows are routed)."""
    if _mesh.is_dtensor(x):
        return _moe_ffn_sharded(p, cfg, x, ctx, n_real)
    if ctx.mesh is None or ctx.n_model_shards == 1:
        return moe_ffn_local(p, cfg, x, n_real)
    from torch.distributed.nn import functional as dist_fn
    B, S, d = x.shape
    lo, n_local = _expert_block(cfg, ctx)
    xf = x.reshape(-1, d)
    out, aux = _rank_experts(xf, p["router"], [p[k][lo:lo + n_local] for k in EXPERT_KEYS],
                             cfg, lo, n_real)
    out = dist_fn.all_reduce(out, group=ctx.mesh.get_group(ctx.model_axis))
    aux = dist_fn.all_reduce(aux, group=ctx.mesh.get_group(ctx.model_axis)) / ctx.n_model_shards
    for a in ctx.data_axes:
        aux = dist_fn.all_reduce(aux, group=ctx.mesh.get_group(a)) / ctx._size(a)
    if cfg.moe.n_shared_experts:       # one MLP, silu whatever cfg.act is, as in the reference
        out = out + mlp(p["shared"], xf, "silu")
    return out.reshape(B, S, d), aux


def _moe_ffn_sharded(p: Params, cfg: ModelConfig, x, ctx: ParallelContext,
                     n_real: Optional[torch.Tensor] = None):
    """The reference's shard_map over DTensors: x (B, S, d) with the batch
    over the data axes and whole over the model axis, the router whole, the
    experts split over the model axis (their other dims gathered, as the
    reference's ``P(model)`` in_specs gather them). Each rank routes its
    tokens, dispatches to its ``E / n_model`` experts with the capacity of
    its tokens, and its partial output is left ``Partial`` over the model
    axis; aux is each data shard's, averaged (``Partial("avg")``) over the
    data axes. The shared experts run outside, over the DTensors. A plain
    ``n_real`` (the engine's padded chunk, whole on every rank) routes only
    the first ``n_real`` rows of each rank's tokens (ROADMAP C30)."""
    from repro_torch.models.attention import _shard
    Shard, Replicate, Partial = (_mesh._types()[i] for i in (1, 2, 3))
    mesh, da, ma = ctx.mesh, ctx.data_axes, ctx.model_axis
    B, S, d = x.shape
    lo, _ = _expert_block(cfg, ctx)
    x = _shard(x, ctx, da, None, None)
    w = [_shard(p[k], ctx, ma, None, None) for k in EXPERT_KEYS]
    router = _shard(p["router"], ctx, None, None)

    def shard_fn(xs, router, *w):
        out, aux = _rank_experts(xs.reshape(-1, d), router, w, cfg, lo, n_real)
        return out.reshape(xs.shape), aux
    names = mesh.mesh_dim_names
    batch = [_mesh.shard_dim(q, 3) == 0 for q in x.placements]
    out_pl = [Partial() if n == ma else (Shard(0) if b else Replicate())
              for n, b in zip(names, batch)]
    aux_pl = [Partial("avg") if b else Replicate() for b in batch]
    out, aux = _mesh.local(shard_fn, mesh, (x, router, *w), (out_pl, aux_pl))
    if cfg.moe.n_shared_experts:       # one MLP, silu whatever cfg.act is, as in the reference
        out = out + mlp(p["shared"], x.reshape(-1, d), "silu").reshape(B, S, d)
    return out, aux
