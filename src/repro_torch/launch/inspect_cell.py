"""Perf-iteration profiler: count one cell on ``meta`` and print the top
HBM-byte, FLOP and collective contributors, by aten op and by the model
functions it ran in (the dry-run analogue of ``ncu --print-summary``); the
twin of ``src/repro/launch/inspect_cell.py``, which reads the same from the
HLO's op metadata.

The compute, memory and collective milliseconds are the counts over the
rates of a ``DeviceModel`` of ``core/resources.py`` (``--device``, the
``H100`` model by default): its ``mxu_flops``, ``hbm_bw`` and ``ici_bw``.
The count is one device's unless ``--recipe`` or ``--multi-pod`` asks for
one chip of the production mesh (16x16, or 2x16x16 with ``--multi-pod``)
under a recipe (the cell's own where only ``--multi-pod`` is given), as the
reference's does.

  PYTHONPATH=src python -m repro_torch.launch.inspect_cell --arch falcon-mamba-7b \\
      --shape train_4k [--microbatches 8] [--recipe fsdp_tp] [--multi-pod] [--device h100_nvl]
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config
from repro_torch.core import DEVICES, H100
from repro_torch.core.roofline import EFFECTIVE_LINKS
from repro_torch.launch import dryrun as dr
from repro_torch.launch import mesh as mesh_mod
from repro_torch.parallel import sharding as shd


def top_contributors(cfg, shape, run=None, multi_pod=None) -> dict:
    """{"hbm" | "flops" | "coll": {"<op> <site>": count}} of one cell (a
    config and a ``ShapeConfig``) on one device (``multi_pod`` None) or on
    one chip of the production mesh under ``run.sharding_recipe`` (in a
    ``fake`` world of this process), and the counter's ``ModuleStats``
    under "stats"."""
    run = run or dr.default_run(cfg, shape, {None: 1, False: 16, True: 32}[multi_pod])
    cfg = cfg.with_overrides(remat_policy=run.remat_policy or cfg.remat_policy,
                             layer_group=run.layer_group or cfg.layer_group)
    if multi_pod is None:
        counter = dr.count_cell(cfg, shape, run, by_site=True)[0]
    else:
        recipe = run.sharding_recipe
        if recipe == "auto":
            recipe = shd.pick_recipe(cfg, shape)
        with mesh_mod.fake_world(512 if multi_pod else 256):
            mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
            counter = dr.count_cell(cfg, shape, run, by_site=True, mesh=mesh,
                                    recipe=recipe)[0]
    return {**{k: dict(v) for k, v in counter.by_site.items()}, "stats": counter.stats}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--recipe", default=None)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--optimizer", default=None)
    ap.add_argument("--topk", type=int, default=12)
    ap.add_argument("--device", default=H100.name, choices=sorted(DEVICES),
                    help="the DeviceModel whose rates turn counts into ms")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    pod = None if args.recipe is None and not args.multi_pod else args.multi_pod
    run = dr.default_run(cfg, SHAPES[args.shape], {None: 1, False: 16, True: 32}[pod])
    kw = {}
    if args.microbatches:
        kw["num_microbatches"] = args.microbatches
    if args.recipe:
        kw["sharding_recipe"] = args.recipe
    if args.remat:
        kw["remat_policy"] = args.remat
    if args.optimizer:
        kw["optimizer"] = args.optimizer
    if kw:
        run = dataclasses.replace(run, **kw)

    top = top_contributors(cfg, SHAPES[args.shape], run, pod)
    st, dev = top["stats"], DEVICES[args.device]
    recipe = run.sharding_recipe if pod is None or run.sharding_recipe != "auto" else \
        shd.pick_recipe(cfg, SHAPES[args.shape])
    where = dr.mesh_tag(pod) + ("" if pod is None else f" recipe={recipe}")
    print(f"\n=== {args.arch} {args.shape} {where} mb={run.num_microbatches} "
          f"remat={run.remat_policy} device model {dev.name} ===")
    print(f"compute {st.mxu_flops / dev.mxu_flops * 1e3:9.1f} ms   "
          f"memory {st.hbm_bytes / dev.hbm_bw * 1e3:9.1f} ms   "
          f"collective {st.collective_bytes / (dev.ici_bw * EFFECTIVE_LINKS) * 1e3:9.1f} ms")

    for title, d, unit in (("HBM bytes", top["hbm"], 1e9),
                           ("MXU flops", top["flops"], 1e12),
                           ("collective bytes", top["coll"], 1e9)):
        tot = sum(d.values())
        print(f"\n--- top {title} (total {tot / unit:.2f} "
              f"{'GB' if unit == 1e9 else 'TF'}) ---")
        for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:args.topk]:
            print(f"{v / unit:10.3f} ({v / max(tot, 1e-9) * 100:4.1f}%)  {k}")


if __name__ == "__main__":
    main()
