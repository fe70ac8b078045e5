"""A new cell, configuration, traffic mix or per-layer metric is new files
and new entries in BENCHMARK.json: the harness finds each by its name."""
import json
import time

import pytest

from conftest import TINY_CONFIGS, TINY_TRAFFIC
from gpubench import run, spec


def add_cell(root, config, mix, metric):
    base = root / "gpubench"
    (base / "configs" / f"{config}.json").write_text(json.dumps(TINY_CONFIGS["tiny-dense"]))
    (base / "traffic" / f"{mix}.json").write_text(json.dumps(TINY_TRAFFIC["tiny_chat"]))
    name = f"{config}.{mix}"
    (base / "cells" / f"{name}.json").write_text(json.dumps({"rate_per_s": 5.0,
                                                             "logit_gap_limit": 0.05}))
    (base / "metrics" / f"{metric}.py").write_text(
        "def read(rec):\n    return float(len(rec['requests']))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": config, "source": "tiny", "reduced": [], "why": "new",
                             "file": f"gpubench/configs/{config}.json"})
    bench["workloads"].append({"name": name, "config": config, "traffic": mix, "chips": 1,
                               "why": "new"})
    bench["per_layer"].append({"name": metric, "unit": "requests", "better": "higher",
                               "source": "host_clock", "layer": "engine",
                               "moves": "tokens_per_s", "workloads": [name]})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return name


def test_new_files_alone_make_a_new_cell(tiny_root):
    name = add_cell(tiny_root, "tiny-new", "tiny_new_mix", "requests_seen.new")
    cell = spec.load_cell(name, tiny_root, tiny_root / "gpubench")
    assert cell.traffic == TINY_TRAFFIC["tiny_chat"]
    assert cell.config == TINY_CONFIGS["tiny-dense"]
    assert [m.name for m in cell.per_layer] == ["requests_seen.new"]
    read = spec.load_reader("requests_seen.new", tiny_root / "gpubench")
    assert read({"requests": [1, 2, 3]}) == 3.0
    out = run.run(name, 2 ** 35, 1.0, False, device="cpu", root=tiny_root,
                  t_start=time.perf_counter())
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"ttft_p95_ms", "tbt_p99_ms", "tokens_per_s", "setup_s"}
    assert list(out)[-1] == "checks"


def test_an_unknown_name_is_refused(tiny_root):
    with pytest.raises(KeyError):
        spec.load_cell("no-such.cell", tiny_root, tiny_root / "gpubench")
    with pytest.raises(FileNotFoundError):
        spec.load_reader("no_such_metric", tiny_root / "gpubench")


def test_the_benchmark_names_a_file_for_every_part():
    from gpubench.spec import HERE, ROOT
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (ROOT / c["file"]).exists()
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.chips == 1
        assert any(m.name == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        moved = {m.name for m in cell.end_to_end}
        assert all(m.moves in moved for m in cell.per_layer), w["name"]
        assert "logit_gap_limit" in cell.cell
    for m in bench["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
