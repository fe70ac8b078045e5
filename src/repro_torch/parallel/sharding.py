"""Sharding recipes: map every param / input / cache leaf to a placement
spec; the twin of ``src/repro/parallel/sharding.py``.

A spec is a tuple with one entry a dim: ``None`` (replicated), a mesh axis
name, or a tuple of axis names (the dim split over all of them), as the
reference's ``PartitionSpec``; ``()`` replicates the whole leaf. The
recipes are pure functions of a leaf's path and shape and of the mesh's
axis sizes, so they run without devices: a mesh is anything with
``axis_names`` and a ``shape`` mapping (the tests' ``FakeMesh``), or a
``torch.distributed`` ``DeviceMesh`` with dim names.

Recipes (DESIGN.md §5):
  fsdp_tp   — train default. TP dim over `model`; the other matmul dim over
              the data axes (ZeRO-3); batch over data axes.
  dp_tp     — replicated weights + TP; batch over data axes (small models).
  tp_serve  — decode: weights TP over `model` only (replicated over data);
              batch over data; KV-cache *sequence* over `model`
              (flash-decode SP: softmax reductions psum over `model`).
  tp2d_serve— decode for models too big to replicate over data: weights 2D
              (d over data axes, heads/ff over model); cache batch over
              data, sequence over model; activation reshards are
              decode-sized (tiny).

Rules are applied by *leaf path suffix* ("stack/attn/wq", the keys of the
parameter and cache dicts joined by "/", as the reference's tree paths) and
aligned to the trailing dims of each leaf, so stacked layouts ((L, ...),
(g, r, ...), …) inherit the same rule with leading scan dims replicated.

``to_placements`` turns a spec into DTensor placements over a
``DeviceMesh`` (``named`` does it for a tree, the twin of the reference's
``NamedSharding`` tree), and ``distribute`` realises a tree of specs where
a process group exists: each leaf a DTensor, a ``meta`` leaf as each
rank's ``meta`` block (no data moves: the dry run's placed tree). The
model's steps take the distributed tree with a ``ParallelContext``
(``models/model.py``).
"""
from __future__ import annotations

import math
import re
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig

Spec = Tuple


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a FakeMesh-like object or a DeviceMesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                       # a torch DeviceMesh
        return {n: int(s) for n, s in zip(names, mesh.shape)}
    return dict(mesh.shape)


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh_shape(mesh))


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    sizes = mesh_shape(mesh)
    return int(math.prod(sizes[a] for a in axes))


def data_axes_of(mesh) -> Tuple[str, ...]:
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def pick_recipe(cfg: ModelConfig, shape: ShapeConfig) -> str:
    big = cfg.n_params() * 2 > 12e9   # bf16 bytes vs ~12GB budget/chip
    if shape.kind == "train":
        return "fsdp_tp" if cfg.n_params() * 2 > 1e9 else "dp_tp"
    if shape.kind == "prefill":
        return "fsdp_tp" if big else "dp_tp"
    return "tp2d_serve" if big else "tp_serve"


# --------------------------------------------------------------------- #
#  Parameter rules                                                       #
# --------------------------------------------------------------------- #
def _param_rule(path: str, cfg: ModelConfig, recipe: str, mesh, ndim: int) -> Spec:
    """Returns the spec of a leaf, its rule aligned to the TRAILING dims."""
    d = data_axes_of(mesh)
    fsdp = d if recipe == "fsdp_tp" else (d if recipe == "tp2d_serve" else None)
    m = "model" if "model" in axis_names(mesh) else None

    def rule():
        # ---- embeddings ----
        if path.endswith("embed/embedding"):
            return (m, fsdp)                      # (V, d)
        if path.endswith("embed/unembed"):
            return (fsdp, m)                      # (d, V)
        # ---- attention ----
        if re.search(r"(attn|xattn)/w[kv]$", path):
            # shard kv heads only when they divide the model axis (else the
            # flat (KVH*hd) shard would split a head: forced reshards)
            ok = m and cfg.attn.n_kv_heads % mesh_shape(mesh)["model"] == 0
            return (fsdp, m if ok else None)
        if re.search(r"(attn|xattn)/wq$", path):
            return (fsdp, m)                      # (d_in, heads*hd)
        if re.search(r"(attn|xattn)/wo$", path):
            return (m, fsdp)                      # (heads*hd, d)
        if re.search(r"/(q_norm|k_norm|gate)$", path) and not path.endswith("w_gate"):
            return ()
        # ---- MoE ----
        if "moe/router" in path:
            return (None, None)
        if re.search(r"moe/w_(gate|up)$", path):
            return (m, fsdp, None)                # (E, d, f)
        if path.endswith("moe/w_down"):
            return (m, None, fsdp)                # (E, f, d)
        if re.search(r"shared/w_(gate|up)$", path):
            return (fsdp, m)
        if path.endswith("shared/w_down"):
            return (m, fsdp)
        # ---- dense MLP ----
        if re.search(r"mlp/w_(gate|up)$", path):
            return (fsdp, m)
        if path.endswith("mlp/w_down"):
            return (m, fsdp)
        # ---- mamba (1 & 2) ----
        if re.search(r"mixer/in_[xz]$", path):
            return (fsdp, m)                      # (d, di) channels TP
        if path.endswith("mixer/x_proj"):
            return (m, None)                      # (di, r+2N)
        if path.endswith("mixer/dt_proj"):
            return (None, m)                      # (r, di)
        if path.endswith("mixer/A_log") and ndim >= 2 and cfg.ssm.variant == "mamba1":
            return (m, None)                      # (di, N)
        # ---- mamba2 ----
        if path.endswith("mixer/in_dt"):
            return (fsdp, m)
        if path.endswith("mixer/in_bc"):
            return (fsdp, None)
        if path.endswith("mixer/conv_x_w") or path.endswith("mixer/conv_w"):
            return (m, None)                      # (di, K)
        if re.search(r"mixer/conv_(x_)?b$", path):
            return (m,)
        if path.endswith("mixer/conv_bc_w"):
            return (None, None)
        if path.endswith("mixer/conv_bc_b"):
            return (None,)
        if re.search(r"mixer/(A_log|D|dt_bias)$", path):
            return (m,)                           # (di,) or (H,)
        if path.endswith("mixer/norm/scale"):
            return (m,)                           # (di,) gated-norm scale
        if path.endswith("mixer/out_proj"):
            return (m, fsdp)                      # (di, d)
        # ---- norms & rest ----
        if path.endswith("scale"):
            return (None,)
        return None                               # replicate fully

    r = rule()
    if r is None:
        return ()
    r = _canon(r)
    assert len(r) <= ndim, f"{path}: rule {r} longer than ndim {ndim}"
    return (None,) * (ndim - len(r)) + r


def _with_paths(fn, tree, path: str = ""):
    """``fn(path, leaf)`` at every leaf of a tree of dicts, tuples and
    lists (``None`` stays ``None``, as no leaf of the reference's tree)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _with_paths(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_with_paths(fn, v, f"{path}/{i}" if path else str(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _canon(spec) -> Spec:
    """One-axis tuples as the axis (('data',) -> 'data'), as
    ``PartitionSpec`` writes them."""
    return tuple(ax[0] if isinstance(ax, tuple) and len(ax) == 1 else ax for ax in spec)


def sanitize(spec: Spec, shape, mesh) -> Spec:
    """Drop axes from dims they don't evenly divide (e.g. vocab=504,
    batch=1): divisibility is required for clean partitioning."""
    return _canon(ax if ax is None or shape[i] % _axis_size(mesh, ax) == 0 else None
                  for i, ax in enumerate(spec))


def sanitize_tree(spec_tree, tree, mesh):
    """``sanitize`` at every leaf: the specs of ``spec_tree`` against the
    shapes of the leaves of ``tree`` (the same nesting)."""
    def walk(s, t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(s[k], v) for k, v in t.items()}
        if isinstance(t, (tuple, list)) and not _is_spec(s):
            return type(t)(walk(si, v) for si, v in zip(s, t))
        return sanitize(s, t.shape, mesh)
    return walk(spec_tree, tree)


def _is_spec(s) -> bool:
    return isinstance(s, tuple) and all(a is None or isinstance(a, (str, tuple)) for a in s)


def param_specs(cfg: ModelConfig, recipe: str, mesh, params):
    """params: the parameter tree (its leaves' shapes are read: ``meta``
    tensors do)."""
    def spec(path, leaf):
        s = _param_rule(path, cfg, recipe, mesh, len(leaf.shape))
        return sanitize(s, leaf.shape, mesh)

    return _with_paths(spec, params)


# --------------------------------------------------------------------- #
#  Batch / cache rules                                                   #
# --------------------------------------------------------------------- #
def batch_specs(cfg: ModelConfig, recipe: str, mesh, kind: str):
    d = data_axes_of(mesh)
    tok = (d,) if kind == "decode" else (d, None)     # (B, 1) / (B, S)
    specs = {"tokens": tok, "labels": tok}
    if cfg.family == "audio":
        specs["frames"] = (d, None, None)
        specs.pop("tokens")
    if cfg.family == "vlm":
        specs["vision"] = (d, None, None)
    return {k: _canon(v) for k, v in specs.items()}


def cache_specs(cfg: ModelConfig, recipe: str, mesh, cache,
                seq_axis_shards: Optional[str] = "model"):
    """KV caches: batch over data axes, sequence over `model` (SP decode).
    SSM states: batch over data, channels/heads over `model`."""
    d = data_axes_of(mesh)
    m = seq_axis_shards if "model" in axis_names(mesh) else None

    def spec(path, leaf):
        nd = len(leaf.shape)

        def trail(r):
            s = sanitize((None,) * (nd - len(r)) + tuple(r), leaf.shape, mesh)
            # long-context fallback: batch too small to shard -> put the
            # sequence dim over data axes too (SP over the whole mesh)
            if (r and r[0] == d and s[nd - len(r)] is None and len(r) >= 4
                    and m is not None):
                seq_i = nd - len(r) + 1
                if leaf.shape[seq_i] % (_axis_size(mesh, d) * _axis_size(mesh, m)) == 0:
                    full = list(s)
                    full[seq_i] = tuple(d) + ("model",)
                    s = tuple(full)
            return s

        if re.search(r"(^|/)(k|v|global_k|global_v|attn_k|attn_v)$", path):
            return trail((d, m, None, None))          # (..., B, S, KVH, D)
        if re.search(r"(local_k|local_v|tail_k|tail_v)$", path):
            return trail((d, None, None, None))       # ring window unsharded
        if re.search(r"cross_(k|v)$", path):
            return trail((d, None, None, None))
        if path.endswith("h") and cfg.ssm.variant == "mamba1":
            return trail((d, "model", None))           # (..., B, di, N)
        if path.endswith("h"):
            return trail((d, "model", None, None))     # (..., B, H, P, N)
        if path.endswith("conv_x") or path.endswith("conv"):
            return trail((d, None, "model"))
        if path.endswith("conv_bc"):
            return trail((d, None, None))
        return ()

    return _with_paths(spec, cache)


# --------------------------------------------------------------------- #
#  Realising a spec: DTensor placements                                  #
# --------------------------------------------------------------------- #
def to_placements(spec: Spec, mesh) -> list:
    """One placement a dim of the ``DeviceMesh``: ``Shard(i)`` where the
    spec puts that mesh axis on tensor dim i, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for i, ax in enumerate(spec):
        for a in ((ax,) if isinstance(ax, str) else (ax or ())):
            where[a] = i
    return [Shard(where[n]) if n in where else Replicate() for n in mesh.mesh_dim_names]


def named(mesh, spec_tree):
    """The placements of every spec of a tree (the twin of the reference's
    ``named``: a ``NamedSharding`` a leaf)."""
    if spec_tree is None:
        return None
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, list) or (isinstance(spec_tree, tuple) and not _is_spec(spec_tree)):
        return type(spec_tree)(named(mesh, v) for v in spec_tree)
    return tuple(to_placements(spec_tree, mesh))


def local_shape(shape, placements, mesh) -> tuple:
    """One rank's block of a tensor of ``shape`` placed by ``placements``
    (dims that the placements split evenly, as ``sanitize`` leaves them)."""
    from torch.distributed.tensor import Shard
    out = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            out[p.dim] //= mesh.size(i)
    return tuple(out)


def distribute(tree, mesh, specs):
    """Each leaf of ``tree`` as a DTensor over ``mesh`` placed by its spec
    (the same nesting as ``tree``). Needs the process group of the mesh. A
    DTensor leaf is moved to its spec's placements (the reference's
    out_shardings); a ``meta`` leaf becomes each rank's ``meta`` block:
    nothing is sent."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(t, s):
        pl = to_placements(s, mesh)
        if isinstance(t, DTensor):
            return t if tuple(t.placements) == tuple(pl) else t.redistribute(mesh, pl)
        if t.device.type != "meta":
            return distribute_tensor(t, mesh, pl)
        block = torch.empty(local_shape(t.shape, pl, mesh), dtype=t.dtype, device="meta")
        return DTensor.from_local(block, mesh, pl, run_check=False, shape=t.shape,
                                  stride=t.stride())

    def walk(t, s):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(v, s[k]) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(walk(v, si) for v, si in zip(t, s))
        return one(t, s)
    return walk(tree, specs)

