"""Shared fixtures: a checkout in a temporary folder that holds one tiny
cell of each loop, built from the benchmark's own files plus tiny ones."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_CONFIGS = {
    "tiny-dense": {"registry": "qwen3-1.7b", "reduced": ["num_hidden_layers", "hidden_size"],
                   "overrides": {"n_layers": 2, "d_model": 64, "d_ff": 128, "vocab_size": 256,
                                 "attn": {"n_heads": 4, "n_kv_heads": 2, "head_dim": 16}}},
    "tiny-moe": {"registry": "phi3.5-moe-42b-a6.6b", "reduced": ["num_hidden_layers"],
                 "overrides": {"n_layers": 2, "d_model": 64, "d_ff": 128, "vocab_size": 256,
                               "attn": {"n_heads": 4, "n_kv_heads": 2, "head_dim": 16},
                               "moe": {"n_experts": 4, "top_k": 2, "d_ff_expert": 64,
                                       "capacity_factor": 8.0}}},
}
TINY_TRAFFIC = {
    "tiny_chat": {"loop": "open", "prompt": {"dist": "lognormal", "median": 24, "sigma": 0.6,
                                             "min": 4, "max": 80},
                  "output": {"dist": "lognormal", "median": 6, "sigma": 0.5, "min": 2, "max": 16},
                  "lead_s": 0.5, "grace_s": 30.0,
                  "engine": {"max_slots": 4, "max_len": 96, "prefill_chunk": 32,
                             "tbt_slo_ms": 50.0, "mode": "interference_aware"},
                  "check": {"min_tokens": 20, "max_requests": 4}},
    "tiny_backlog": {"loop": "backlog", "prompt": {"dist": "lognormal", "median": 12, "sigma": 0.5,
                                                   "min": 4, "max": 32},
                     "output": {"dist": "lognormal", "median": 8, "sigma": 0.5, "min": 2, "max": 24},
                     "warm_lifetimes": 1.0,
                     "engine": {"max_slots": 4, "max_len": 64, "prefill_chunk": 32,
                                "tbt_slo_ms": 50.0, "mode": "interference_aware"},
                     "check": {"min_tokens": 20, "max_requests": 4}},
}


def make_root(tmp: Path, cells, limit: float = 0.15, rate: float = 6.0) -> Path:
    """A checkout under ``tmp``: BENCHMARK.json with ``cells`` (config,
    traffic) pairs, the benchmark's metrics readers and its tiny files."""
    base = tmp / "gpubench"
    shutil.copytree(ROOT / "gpubench" / "metrics", base / "metrics")
    for d in ("configs", "traffic", "cells"):
        (base / d).mkdir(parents=True, exist_ok=True)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"], bench["workloads"] = [], []
    for config, mix in cells:
        name = f"{config}.{mix}"
        if not (base / "configs" / f"{config}.json").exists():
            (base / "configs" / f"{config}.json").write_text(json.dumps(TINY_CONFIGS[config]))
            bench["configs"].append({"name": config, "source": "tiny", "reduced": [],
                                     "file": f"gpubench/configs/{config}.json", "why": "tiny"})
        (base / "traffic" / f"{mix}.json").write_text(json.dumps(TINY_TRAFFIC[mix]))
        (base / "cells" / f"{name}.json").write_text(
            json.dumps({"rate_per_s": rate, "logit_gap_limit": limit}))
        bench["workloads"].append({"name": name, "config": config, "traffic": mix,
                                   "chips": 1, "why": "tiny"})
    names = [w["name"] for w in bench["workloads"]]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = names
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; decides inside the test and skips without one")


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path, [("tiny-dense", "tiny_chat"), ("tiny-dense", "tiny_backlog"),
                                ("tiny-moe", "tiny_chat")])
