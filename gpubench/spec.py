"""What a cell is made of, found by name: ``BENCHMARK.json`` names the cells
and metrics, and every part of a cell lives in a file of its own.

  configs/<config>.json    the model: registry name, overrides, the cut
  traffic/<mix>.json       the mix: lengths, arrivals, the engine's settings
  cells/<workload>.json    what one cell fixes: an open loop's rate, the
                           limit of its correctness check
  metrics/<metric>.py      one reader a per-layer metric: ``read(record)``

A later cell, configuration, mix or metric is a new file and a new entry.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent          # gpubench/
ROOT = HERE.parent                              # the checkout


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    layer: Optional[str] = None
    moves: Optional[str] = None
    workloads: Optional[List[str]] = None

    def applies(self, workload: str) -> bool:
        return self.workloads is None or workload in self.workloads


@dataclass
class Cell:
    name: str
    config: Dict            # configs/<config>.json
    traffic: Dict           # traffic/<mix>.json
    cell: Dict              # cells/<workload>.json
    chips: int
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _metrics(entries) -> List[Metric]:
    return [Metric(e["name"], e["unit"], e["better"], e["source"], e.get("layer"),
                   e.get("moves"), e.get("workloads")) for e in entries]


def load_cell(workload: str, root: Path = ROOT, base: Path = HERE) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files from
    ``base`` (the benchmark's folder)."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    config = _json(root / cfg_entry["file"])
    e2e = [m for m in _metrics(bench["end_to_end"]) if m.applies(workload)]
    per = [m for m in _metrics(bench["per_layer"]) if m.applies(workload)]
    return Cell(workload, config, load_traffic(w["traffic"], base),
                load_cell_file(workload, base), int(w["chips"]), e2e, per)


def load_traffic(mix: str, base: Path = HERE) -> Dict:
    return _json(base / "traffic" / f"{mix}.json")


def load_cell_file(workload: str, base: Path = HERE) -> Dict:
    return _json(base / "cells" / f"{workload}.json")


def load_reader(metric: str, base: Path = HERE) -> Callable:
    """``read`` of ``metrics/<metric>.py``, loaded from its file (a metric's
    name may hold dots, which an import path cannot)."""
    path = base / "metrics" / f"{metric}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for per-layer metric {metric!r}: {path}")
    mod_name = "gpubench_metric_" + "".join(c if c.isalnum() else "_" for c in metric)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
