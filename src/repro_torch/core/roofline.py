"""Roofline analysis over dry-run artifacts (EXPERIMENTS.md §Roofline).

Per (arch x shape x mesh) cell, the three terms in seconds:
  compute   = HLO_mxu_FLOPs_per_chip / peak_FLOP/s
  memory    = HLO_bytes_per_chip / HBM_bw
  collective= collective_bytes_per_chip / (links x link_bw)

plus MODEL_FLOPS = 6*N*D (train) / 2*N*D (prefill) / 2*N_active*B (decode)
and the useful-compute ratio MODEL_FLOPS / HLO_FLOPs (remat/redundancy).

The records follow the JSON schema of the reference package's dry run
(``src/repro/launch/dryrun.py``); this package's writer of that schema is
``repro_torch.launch.dryrun``, whose one-device records (``dev1``) this
reader takes as they are.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.core.resources import TPU_V5E, DeviceModel

# 16x16 torus: each chip has 4 ICI links; bidirectional rings give ~3
# usable links of effective bandwidth for typical collectives — we report
# conservatively with 1.5 effective links (mixed all-reduce/all-gather).
EFFECTIVE_LINKS = 1.5


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    kind: str
    recipe: str
    n_chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops: float            # global
    useful_ratio: float
    bound: str
    roofline_frac: float        # model-flops-time / bound-time
    fits_hbm: bool
    hbm_gb: float

    def row(self) -> str:
        return (f"| {self.arch} | {self.shape} | {self.mesh} | {self.recipe} "
                f"| {self.compute_s * 1e3:.1f} | {self.memory_s * 1e3:.1f} "
                f"| {self.collective_s * 1e3:.1f} | {self.bound} "
                f"| {self.useful_ratio:.2f} | {self.roofline_frac:.3f} "
                f"| {self.hbm_gb:.1f} |")


def model_flops_of(rec: dict) -> float:
    n_tok_map = {"train_4k": 4096 * 256, "prefill_32k": 32768 * 32}
    shape, kind = rec["shape"], rec["kind"]
    n = rec["n_params"]
    n_act = rec["n_active_params"]
    if kind == "train":
        return 6.0 * n_act * n_tok_map[shape]
    if kind == "prefill":
        return 2.0 * n_act * n_tok_map[shape]
    # decode: one token per sequence
    batch = {"decode_32k": 128, "long_500k": 1}[shape]
    return 2.0 * n_act * batch


def analyze_record(rec: dict, dev: DeviceModel = TPU_V5E) -> RooflineRow:
    n = rec["n_chips"]
    h = rec["hlo_exec"]
    compute = h["mxu_flops"] / dev.mxu_flops
    memory = h["hbm_bytes"] / dev.hbm_bw
    coll = rec["collectives"]["total_bytes"] / (dev.ici_bw * EFFECTIVE_LINKS)
    mf = model_flops_of(rec)
    hlo_total = h["mxu_flops"] * n
    bound_s = max(compute, memory, coll, 1e-12)
    bound = {compute: "compute", memory: "memory", coll: "collective"}[
        max(compute, memory, coll)]
    ideal = mf / n / dev.mxu_flops
    mem = rec["memory"]
    # outputs aliased to donated inputs (decode cache) are not extra HBM
    hbm_gb = (mem["argument_bytes"] + mem["temp_bytes"]
              + mem["output_bytes"] - mem.get("alias_bytes", 0)) / 1e9
    return RooflineRow(
        arch=rec["arch"], shape=rec["shape"],
        mesh="2x16x16" if rec.get("multi_pod") else "16x16",
        kind=rec["kind"], recipe=rec.get("recipe", "?"), n_chips=n,
        compute_s=compute, memory_s=memory, collective_s=coll,
        model_flops=mf, hlo_flops=hlo_total,
        useful_ratio=mf / max(hlo_total, 1e-9),
        bound=bound, roofline_frac=ideal / bound_s,
        fits_hbm=hbm_gb <= dev.hbm_capacity / 1e9, hbm_gb=hbm_gb)


def load_results(results_dir: str = "results/dryrun",
                 tag: str = "") -> List[RooflineRow]:
    rows = []
    for f in sorted(Path(results_dir).glob("*.json")):
        rec = json.loads(f.read_text())
        if rec.get("skipped"):
            continue
        if tag != rec.get("tag", ""):
            continue
        rows.append(analyze_record(rec))
    return rows


HEADER = ("| arch | shape | mesh | recipe | compute ms | memory ms "
          "| collective ms | bound | useful | roofline | HBM GB/chip |\n"
          "|---|---|---|---|---|---|---|---|---|---|---|")


def table(rows: List[RooflineRow]) -> str:
    return "\n".join([HEADER] + [r.row() for r in rows])
