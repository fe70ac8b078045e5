"""The port stands alone: importing every module of ``repro_torch``, and
``chip_smoke.py``'s imports, in a fresh interpreter leaves neither ``jax``
nor ``repro`` in ``sys.modules``, and starts no build."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
%s
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax", "triton"))
print("MODULES", len(names), "BAD", bad)
"""


def run_probe(extra: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", PROBE % extra], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_package_imports_neither_jax_nor_repro():
    out = run_probe("")
    line = [ln for ln in out.splitlines() if ln.startswith("MODULES")][-1]
    n = int(line.split()[1])
    assert n >= 30, line                      # every sub-package was walked
    assert line.endswith("BAD []"), line


def test_chip_smoke_imports_neither_jax_nor_repro():
    out = run_probe("import chip_smoke")
    assert [ln for ln in out.splitlines() if ln.startswith("MODULES")][-1].endswith("BAD []")


def test_import_builds_nothing():
    before = set((ROOT / "build").rglob("*")) if (ROOT / "build").exists() else set()
    run_probe("import chip_smoke")
    after = set((ROOT / "build").rglob("*")) if (ROOT / "build").exists() else set()
    assert after == before


def test_sources_name_no_jax_import():
    """No module of the port, nor chip_smoke.py, has an import of jax or of
    the JAX package in its text."""
    files = list((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    for f in files:
        for ln in f.read_text().splitlines():
            s = ln.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1].split(".")[0]
                assert mod not in ("jax", "jaxlib", "repro"), (f, ln)
