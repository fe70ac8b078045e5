"""One run of one cell, in parts that ``run.py``, ``sweep.py`` and
``calibrate.py`` share: the set-up (kernels, weights, engine, warm-up), the
window, and the check against the reference.

Nothing here imports ``jax``, the JAX package ``repro`` or ``benchmarks/``;
``forbidden_modules`` looks for them in ``sys.modules`` once the window
has closed.
"""
from __future__ import annotations

import gc
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / "build" / "gpubench"     # fixed, inside the checkout, listed in .gitignore
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
clock = time.perf_counter


def prepare() -> None:
    """Before torch is imported: the caches at fixed paths in the checkout,
    no JAX behind a library's back, and the port importable from ``src``."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> List[str]:
    """Modules in this process whose top-level name, compared whole, is
    JAX's, flax's, the JAX package's or the JAX benchmarks'."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_info() -> str:
    """The card's name, power limit and clocks, as nvidia-smi reads them."""
    query = "name,power.limit,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out.stdout.strip() or out.stderr.strip()


class Setup:
    """Kernels loaded (built at a checkout's first run), weights drawn from
    the seed, the engine built with its steps captured, one short serve.
    ``parts`` holds the seconds of each."""

    def __init__(self, cell, seed: int, device: str = "cuda", traced: bool = False):
        self.parts: Dict[str, float] = {}
        t = clock()
        import torch
        from gpubench import weights as wt
        from repro_torch.core import set_solver_backend
        from repro_torch.serve.engine import Engine, EngineConfig
        self.parts["import_s"] = clock() - t
        self.device = device
        if device == "cuda":
            t = clock()
            from repro_torch.kernels import _build
            self.built = not _build.library_path().exists()
            _build.load()
            self.parts["kernels_build_s" if self.built else "kernels_load_s"] = clock() - t
        set_solver_backend("torch", device=device)
        self.cfg = wt.model_config(cell.config)
        self.shape = wt.shape(self.cfg)
        t = clock()
        self.weights = wt.draw(self.shape, seed, device)
        self._sync()
        self.parts["weights_s"] = clock() - t
        self.weight_bytes = wt.n_bytes(self.weights)
        t = clock()
        self.ecfg = EngineConfig(**cell.traffic["engine"])
        self.eng = Engine(self.cfg, params=self.weights, ecfg=self.ecfg, device=device)
        self._sync()
        self.parts["engine_s"] = clock() - t
        self.captures = {s.name: s.capture_s for s in self.eng.steps.values()}
        t = clock()
        self.warm_serve()
        self.parts["warm_serve_s"] = clock() - t
        if traced:
            from gpubench import trace
            self.parts["profiler_warm_s"] = trace.warm()

    def _sync(self) -> None:
        if self.device == "cuda":
            import torch
            torch.cuda.synchronize()

    def warm_serve(self) -> None:
        """A request that decodes while a second one's chunk is priced: the
        sampling, the pricing and the host paths of a step, run once. Its
        records are cleared; the steps were captured with the engine."""
        eng = self.eng
        n = self.ecfg.max_len
        eng.submit([1] * min(40, n // 4), max_new=6)
        eng.step()
        eng.step()
        eng.submit([2] * min(300, n // 2), max_new=3)
        eng.run_until_done()
        if eng.waiting or eng.alloc.active:
            raise RuntimeError("the warm-up serve did not finish")
        self._sync()
        eng.events.clear()
        eng.metrics.clear()

    def free_engine(self) -> None:
        """Drop the engine (its cache and graphs), also where a window froze
        it out of the collector's reach (``drive.settle``)."""
        self.eng = None
        gc.unfreeze()
        gc.collect()
        if self.device == "cuda":
            import torch
            torch.cuda.empty_cache()


def make_window(cell, setup: Setup, seed: int, seconds: float, trace_s: float = 0.0,
                rate: Optional[float] = None):
    """The window's driver and how to run it: (window, run) where ``run()``
    drives it to its end."""
    from gpubench import drive
    from gpubench.traffic import Generator
    mix = cell.traffic
    vocab = setup.shape["vocab_size"]
    if mix["loop"] == "open":
        rate = cell.cell["rate_per_s"] if rate is None else rate
        block = max(1, round(rate * seconds))
        gen = Generator(mix, vocab, seed, block, block / seconds)
        w = drive.Window(setup.eng, gen, seconds, trace_s)
        return w, lambda: w.run_open(mix["lead_s"], mix["grace_s"])
    if mix["loop"] == "backlog":
        gen = Generator(mix, vocab, seed, setup.ecfg.max_slots)
        warm = round(mix["warm_lifetimes"] * float(gen.output_q.mean()))
        w = drive.Window(setup.eng, gen, seconds, trace_s)
        return w, lambda: w.run_backlog(warm)
    raise ValueError(f"unknown loop {mix['loop']!r}")


def readings(cell, seed: int, seconds: float, control: bool = True) -> Dict:
    """The check's readings of one seed on the card (``check.readings``):
    the cell's set-up and a window at its own load, then the sample that a
    run compares, with the float8 control's beside it."""
    from gpubench import check
    su = Setup(cell, seed, "cuda")
    w, drive = make_window(cell, su, seed, seconds)
    drive()
    picked = check.sample(finished(w), seed, **cell.traffic["check"])
    w.close()
    w = None
    su.free_engine()
    return check.readings(su.weights, su.shape, picked, control)


def finished(w) -> List[Dict]:
    return [{"prompt": t.req.prompt, "served": list(t.seq.tokens[len(t.req.prompt):])}
            for t in w.tracked if t.seq.done]


def unserved(rec: Dict) -> int:
    """Requests due in the window that never got their first token."""
    from gpubench import reduce
    return sum(1 for r in reduce.due_in_window(rec) if not r["times"])


def lateness_ms(rec: Dict) -> Dict[str, float]:
    """How late an open loop's generator submitted requests after they were
    due (a backlog's requests are due when the queue takes them)."""
    from gpubench import reduce
    late = [(r["submit"] - r["due"]) * 1e3 for r in rec["requests"]]
    return {"p50": reduce.pct(late, 50), "p99": reduce.pct(late, 99),
            "max": max(late) if late else math.nan}
