"""Nothing that the benchmark runs imports JAX, flax, the JAX package
``repro`` or the JAX benchmarks, compared by whole top-level names (the
port's name, ``repro_torch``, begins with ``repro``)."""
import ast
import json
import subprocess
import sys
from pathlib import Path

from gpubench import harness

BENCH = Path(__file__).resolve().parents[1]


def imported_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_of_the_benchmark_names_them():
    files = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]
    assert any(p.parent.name == "metrics" for p in files)
    assert any(p.parent.name == "reference" for p in files)
    for p in files:
        bad = imported_names(p) & set(harness.FORBIDDEN)
        assert not bad, f"{p} imports {bad}"


def test_the_reference_imports_nothing_of_the_port():
    for p in (BENCH / "reference").rglob("*.py"):
        assert imported_names(p) <= {"__future__", "math", "typing", "torch"}, p


def test_a_run_loads_none_of_them(tmp_path):
    """A whole run on the CPU in a fresh process (a tiny cell, every module
    of the harness, the metrics and the reference), then ``sys.modules``."""
    code = f"""
import json, sys, time
sys.path.insert(0, {str(BENCH.parent)!r}); sys.path.insert(0, {str(BENCH / 'tests')!r})
from gpubench import harness
harness.prepare()
from pathlib import Path
from conftest import make_root
from gpubench import run, spec, sweep, calibrate, reduce, check, counts, traffic, weights, drive
from gpubench.reference import decoder
root = make_root(Path({str(tmp_path)!r}), [("tiny-dense", "tiny_chat"), ("tiny-moe", "tiny_backlog")])
for m in spec.load_cell("tiny-dense.tiny_chat", root, root / "gpubench").per_layer:
    spec.load_reader(m.name, root / "gpubench")
out = run.run("tiny-moe.tiny_backlog", 3, 2.0, False, device="cpu", root=root,
              t_start=time.perf_counter())
print(json.dumps({{"checks": out["checks"], "correct": out["correct"],
                  "found": harness.forbidden_modules()}}))
"""
    env = {k: v for k, v in __import__("os").environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    last = json.loads(p.stdout.strip().splitlines()[-1])
    assert last["found"] == []
    assert last["correct"], last["checks"]
