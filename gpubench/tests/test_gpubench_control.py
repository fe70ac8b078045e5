"""The control on the card: the reference in float8 put in the program's
place fails each cell's limit, on three seeds, at the cell's own size,
while the program's served tokens pass it. It runs on the card only:

    python3 -m pytest -q -m card gpubench/tests/test_gpubench_control.py
"""
import json

import pytest
import torch

from gpubench import harness, spec

SEEDS = (41, 42, 43)


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_control_fails_the_limit(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    harness.prepare()
    cell = spec.load_cell(workload)
    limit = cell.cell["logit_gap_limit"]
    for seed in SEEDS:
        r = harness.readings(cell, seed, 10.0)
        assert r["program"] <= limit < r["control"], (seed, r)
        torch.cuda.empty_cache()
