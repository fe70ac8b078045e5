"""Dry run: count every (arch x shape) cell's executed work on ``meta``
tensors (no allocation) and write it in the reference's JSON schema to
``results/dryrun_torch/*.json``; the twin of ``src/repro/launch/dryrun.py``.

The reference lowers and compiles each cell under the production mesh and
reads the pre-fusion HLO after SPMD partitioning (``repro.core.hlo``).
Here the model, its parameters and its inputs are built on ``meta`` (the
twin of ``jax.eval_shape(model.init)``: no random number is drawn), the
cell's step runs under ``repro_torch.core.hlo.Counter``, and every kernel
wrapper takes its plain version for a ``meta`` tensor, as the reference's
dry run counts its jnp attention (``attn_impl="flashref"``) and never a
Pallas kernel. The steps are those a user runs: ``make_train_step`` (train),
``Model.prefill`` or ``forward`` for an encoder (prefill) and
``Model.decode_step`` (decode, one token a sequence over a full cache).

Counts are **per chip**. Under the production meshes (``multi_pod=False``:
the reference's 16x16 ``pod1``, ``True``: its 2x16x16 ``pod2``) the step is
the sharded forward: the ``meta`` parameters placed by ``param_specs``, the
batch by ``batch_specs``, a decode cache by ``cache_specs`` (and a
prefill's cache left there, as the reference's out_shardings leave it),
the optimiser state by ``param_specs`` of its tree, each a DTensor of one
rank's blocks in a one-process ``fake`` world of 256 or 512 ranks
(``launch/mesh.py:fake_world``), stepped with the reference's
``ParallelContext``; the counter counts rank 0's local work and the
collectives DTensor issues (``core/hlo.py``). ``multi_pod=None``, the
default, is one device (``dev1``: the reference's 1x1 mesh, every recipe
realised as replication, no collective). Files are tagged ``dev1``,
``pod1`` or ``pod2``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.1-8b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes | --mesh pod1] [--skip-done]
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path
from typing import Optional, Union

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import SHAPES, RunConfig, ShapeConfig, supports_shape
from repro_torch.configs.registry import get_config, valid_cells
from repro_torch.core import hlo as hlo_mod
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import build_model
from repro_torch.models.moe import ParallelContext
from repro_torch.parallel import sharding as shd
from repro_torch.train.optimizer import get_optimizer
from repro_torch.train.trainer import make_train_step
from repro_torch.tree import leaves, map_leaves

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
ONE_DEVICE = {"data": 1, "model": 1}
# the serving engine's decode step: 8 slots, a cache of 1,024 positions and
# the trash row (``serve/engine.py``), one token a slot
ENGINE_DECODE = ShapeConfig("decode_engine", 1025, 8, "decode")


def mesh_tag(multi_pod: Optional[bool]) -> str:
    """``dev1`` (one device), ``pod1`` (16x16) or ``pod2`` (2x16x16)."""
    return "dev1" if multi_pod is None else ("pod2" if multi_pod else "pod1")


# ----------------------------------------------------------------- #
#  Per-cell run configuration (hillclimb overrides live here)       #
# ----------------------------------------------------------------- #
def default_run(cfg, shape, n_data_shards: int = 16) -> RunConfig:
    from repro_torch.launch.perf_overrides import PERF_OVERRIDES
    key = (cfg.name, shape.name)
    if key in PERF_OVERRIDES:
        return PERF_OVERRIDES[key]
    if shape.kind == "train":
        big = cfg.n_params() > 30e9
        mb = 16 if big else 4
        mb = max(1, min(mb, shape.global_batch // max(n_data_shards, 1)))
        return RunConfig(
            num_microbatches=mb,
            optimizer="adafactor" if cfg.n_params() > 100e9 else "adamw",
        )
    return RunConfig(num_microbatches=1)


def meta_params(cfg):
    """The model's parameter tree on ``meta``: the shapes and types of
    ``build_model(cfg).init``, drawn under ``FakeTensorMode`` (no memory,
    no random numbers) and handed back as ``meta`` tensors."""
    with FakeTensorMode():
        fake = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    return map_leaves(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), fake)


def input_specs(cfg, shape, model):
    """``meta`` stand-ins for every model input of the cell."""
    B, S = shape.global_batch, shape.seq_len

    def f(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        batch = {}
        if cfg.family == "audio":
            batch["frames"] = f((B, S, cfg.d_model), torch.bfloat16)
        else:
            batch["tokens"] = f((B, S), torch.int64)
        batch["labels"] = f((B, S), torch.int64)
        if cfg.family == "vlm":
            batch["vision"] = f((B, cfg.n_vision_tokens, cfg.d_vision), torch.bfloat16)
        if shape.kind == "prefill":
            batch.pop("labels")
        return batch
    # decode: one new token a sequence against a full cache
    return {"tokens": f((B, 1), torch.int64), "cache": model.init_cache(B, S),
            "pos": f((B,), torch.int64)}


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if type(t).__name__ == "DTensor" else t


def _tree_bytes(tree) -> int:
    """One rank's bytes of a tree's tensors (a DTensor's local block)."""
    return sum(_local(t).numel() * t.element_size() for t in leaves(tree)
               if isinstance(t, torch.Tensor))


def _shape_of(shape: Union[str, ShapeConfig]) -> ShapeConfig:
    return shape if isinstance(shape, ShapeConfig) else SHAPES[shape]


def place_cell(cfg, shape: ShapeConfig, mesh, recipe: str, params, ins, opt_state=None):
    """The reference's placement of a cell (``src/repro/launch/dryrun.py``,
    ``run_cell``): the parameters and the optimiser state by
    ``param_specs``, the batch by ``batch_specs`` (the data axes where none
    is given), a decode step's tokens over the data axes and its cache by
    ``cache_specs``, every spec sanitised. Returns (params, ins, opt_state)
    as DTensors over ``mesh``; the position stays whole."""
    da = shd.data_axes_of(mesh)
    params = shd.distribute(params, mesh, shd.param_specs(cfg, recipe, mesh, params))
    if opt_state is not None:
        opt_state = shd.distribute(opt_state, mesh,
                                   shd.param_specs(cfg, recipe, mesh, opt_state))
    if shape.kind == "decode":
        tok = shd.sanitize((da,), ins["tokens"].shape, mesh)
        ins = dict(ins, tokens=shd.distribute(ins["tokens"], mesh, tok),
                   cache=shd.distribute(ins["cache"], mesh,
                                        shd.cache_specs(cfg, recipe, mesh, ins["cache"])))
    else:
        specs = shd.batch_specs(cfg, recipe, mesh, shape.kind)
        specs = shd.sanitize_tree({k: specs.get(k, (da, None)) for k in ins}, ins, mesh)
        ins = shd.distribute(ins, mesh, specs)
    return params, ins, opt_state


def count_cell(cfg, shape: ShapeConfig, run: RunConfig, by_site: bool = False,
               mesh=None, recipe: Optional[str] = None):
    """Build the cell on ``meta`` and run its step under a counter: on one
    device, or with ``mesh`` (a ``DeviceMesh`` of the ``fake`` world) the
    sharded step of one rank under ``recipe``. Returns (counter, arguments'
    bytes, outputs' bytes, aliased bytes, build seconds, count seconds)."""
    t0 = time.perf_counter()
    model = build_model(cfg, device="meta")
    params = meta_params(cfg)
    ins = input_specs(cfg, shape, model)
    opt = get_optimizer(run.optimizer) if shape.kind == "train" else None
    opt_state = opt.init(params) if opt is not None else None
    ctx = ParallelContext()
    if mesh is not None:
        da = shd.data_axes_of(mesh)
        ctx = ParallelContext(mesh, da, "model",
                              feature_shard_decode=(recipe == "tp2d_serve"))
        params, ins, opt_state = place_cell(cfg, shape, mesh, recipe, params, ins, opt_state)
    arg_bytes = _tree_bytes(params) + _tree_bytes(ins)
    alias = 0
    if shape.kind == "train":
        arg_bytes += _tree_bytes(opt_state)
        step = make_train_step(model, opt, run, ctx)

        def go():
            return step(params, opt_state, ins)
    elif shape.kind == "prefill":
        def go():
            with torch.no_grad():
                if cfg.is_encoder:
                    return model.forward(params, ins, ctx)
                logits, cache = model.prefill(params, ins, shape.seq_len, ctx)
                if mesh is not None:    # the reference's out_shardings: the cache placed
                    cache = shd.distribute(cache, mesh, shd.cache_specs(
                        cfg, recipe, mesh, cache))
                return logits, cache
    else:
        alias = _tree_bytes(ins["cache"])          # updated in place

        def go():
            with torch.no_grad():
                return model.decode_step(params, ins["tokens"], ins["cache"], ins["pos"],
                                         ctx)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    with hlo_mod.Counter(by_site=by_site) as counter:
        out = go()
    t_count = time.perf_counter() - t0
    out_bytes = _tree_bytes(out[0] if shape.kind == "decode" else out) + alias
    return counter, arg_bytes, out_bytes, alias, t_build, t_count


def run_cell(arch: str, shape_name: Union[str, ShapeConfig], *,
             multi_pod: Optional[bool] = None, run: Optional[RunConfig] = None,
             save: bool = True, mesh=None, tag: str = "",
             results: Optional[Path] = None) -> dict:
    """One cell. ``shape_name`` names a cell of ``SHAPES`` or is a
    ``ShapeConfig`` (``ENGINE_DECODE``). ``multi_pod`` None counts one
    device (``dev1``); False or True one chip of the production mesh
    (``pod1``, ``pod2``), built in a ``fake`` world of this process unless
    ``mesh`` (a ``DeviceMesh`` over an initialised world) is given."""
    cfg = get_config(arch)
    shape = _shape_of(shape_name)
    if not supports_shape(cfg, shape):
        return {"arch": arch, "shape": shape.name, "skipped": True}
    if mesh is None and multi_pod is not None:
        n = 512 if multi_pod else 256
        with mesh_mod.fake_world(n):
            return run_cell(arch, shape, multi_pod=multi_pod, run=run, save=save,
                            mesh=mesh_mod.make_production_mesh(multi_pod=multi_pod,
                                                               device_type="cpu"),
                            tag=tag, results=results)
    mesh_shape = dict(ONE_DEVICE) if mesh is None else shd.mesh_shape(mesh)
    n_chips = math.prod(mesh_shape.values())
    data_axes = shd.data_axes_of(mesh) if mesh is not None else ()
    n_data = math.prod(mesh_shape[a] for a in data_axes) if data_axes else 1
    run = run or default_run(cfg, shape, n_data)
    cfg = cfg.with_overrides(attn_impl="flashref",
                             remat_policy=run.remat_policy or cfg.remat_policy,
                             layer_group=run.layer_group or cfg.layer_group)
    recipe = run.sharding_recipe
    if recipe == "auto":
        recipe = shd.pick_recipe(cfg, shape)
    sharded = mesh is not None and n_chips > 1
    counter, arg_bytes, out_bytes, alias, t_build, t_count = count_cell(
        cfg, shape, run, mesh=mesh if sharded else None, recipe=recipe)
    st = counter.stats
    result = {
        "arch": arch, "shape": shape.name, "kind": shape.kind,
        "mesh": mesh_shape, "n_chips": n_chips,
        "recipe": recipe, "multi_pod": bool(multi_pod), "tag": tag,
        "run": {"num_microbatches": run.num_microbatches,
                "optimizer": run.optimizer,
                "remat": run.remat_policy or cfg.remat_policy,
                "recipe": recipe},
        "n_params": cfg.n_params(), "n_active_params": cfg.n_active_params(),
        # building the model and inputs on meta, and the counted run
        "lower_s": t_build, "compile_s": t_count,
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            # the most bytes the step's own results held at once
            "temp_bytes": counter.peak_temp_bytes,
            "alias_bytes": alias,
            "generated_code_bytes": 0,
        },
        # no XLA cost analysis here: the counter's executed totals
        "cost": {"flops": st.mxu_flops + st.vpu_flops,
                 "bytes_accessed": counter.hbm_bytes_boundary,
                 "transcendentals": st.transcendentals},
        "hlo_exec": {"mxu_flops": st.mxu_flops,
                     "vpu_flops": st.vpu_flops,
                     "transcendentals": st.transcendentals,
                     "hbm_bytes": st.hbm_bytes,
                     "hbm_bytes_boundary": counter.hbm_bytes_boundary,
                     "source": "torch_dispatch"},
        "collectives": {"bytes_by_kind": st.coll_bytes_by_kind,
                        "count_by_kind": st.coll_count_by_kind,
                        "total_bytes": st.collective_bytes},
        # no HLO text: the aten calls the counter saw
        "hlo_size_chars": counter.ops,
    }
    if save:
        out_dir = results or RESULTS
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / cell_file(arch, shape.name, tag, multi_pod)).write_text(
            json.dumps(result, indent=1))
    return result


def cell_file(arch: str, shape: str, tag: str = "", multi_pod: Optional[bool] = None) -> str:
    return f"{arch}__{shape}__{mesh_tag(multi_pod)}" + (f"__{tag}" if tag else "") + ".json"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=("dev1", "pod1"), default="dev1",
                    help="one device (default) or one chip of the 16x16 mesh")
    ap.add_argument("--multi-pod", dest="mesh", action="store_const", const="pod2",
                    help="one chip of the 2x16x16 mesh")
    ap.add_argument("--both-meshes", dest="mesh", action="store_const", const="both",
                    help="pod1 and pod2")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    meshes = {"dev1": [None], "pod1": [False], "pod2": [True], "both": [False, True]}[args.mesh]

    cells = valid_cells() if args.all else [(args.arch, args.shape)]
    ok = fail = 0
    t_all = time.perf_counter()
    for (arch, shape), mp in ((c, mp) for c in cells for mp in meshes):
        if args.skip_done and (RESULTS / cell_file(arch, shape, args.tag, mp)).exists():
            print(f"SKIP {arch} {shape} {mesh_tag(mp)}")
            continue
        try:
            t0 = time.perf_counter()
            r = run_cell(arch, shape, multi_pod=mp, tag=args.tag)
            dt = time.perf_counter() - t0
            if r.get("skipped"):
                continue
            print(f"OK   {arch:28s} {shape:12s} {mesh_tag(mp)} count={r['compile_s']:6.1f}s "
                  f"total={dt:6.1f}s mxu_flops={r['hlo_exec']['mxu_flops']:.4g} "
                  f"hbm={r['hlo_exec']['hbm_bytes']:.4g}B "
                  f"coll={r['collectives']['total_bytes']:.3g}B")
            ok += 1
        except Exception as e:
            fail += 1
            print(f"FAIL {arch:28s} {shape:12s}: {e}")
            traceback.print_exc()
    print(f"\ndry-run: {ok} ok, {fail} failed, {time.perf_counter() - t_all:.1f} s")
    raise SystemExit(1 if fail else 0)


if __name__ == "__main__":
    main()
