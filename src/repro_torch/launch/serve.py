"""Serving entry point: continuous batching with interference-aware chunked
prefill.

``main`` prices every prefill chunk on the torch solver on ``--device`` by
default: on the card each price is a torch solve with one ``cache_share``
launch; ``--backend numpy`` prices on the NumPy solver on the host
(ROADMAP C19). ``serve`` is the library function and prices on the
process-wide backend (``repro_torch.core.backend``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
      --requests 8 --mode interference_aware            # on the GPU
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
      --tiny --device cpu                               # small, on the CPU
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config, tiny_config
from repro_torch.core.backend import SOLVER_BACKENDS, solver_backend
from repro_torch.models.moe import LOCAL_CTX, ParallelContext
from repro_torch.serve import Engine, EngineConfig


def serve(cfg, ecfg: EngineConfig, prompts, max_new: int, device="cuda",
          params=None, ctx: ParallelContext = LOCAL_CTX):
    """Run ``prompts`` through a fresh engine (under ``ctx``) to completion.
    Returns (engine, metrics, seconds); the clock starts after the engine
    is built (on the card its steps are captured then, as the reference
    compiles them before its clock) and stops after the device has
    finished."""
    eng = Engine(cfg, params=params, ecfg=ecfg, device=device, ctx=ctx)
    for prompt in prompts:
        eng.submit(prompt, max_new=max_new)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    t0 = time.perf_counter()
    metrics = eng.run_until_done()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    return eng, metrics, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--mode", default="interference_aware",
                    choices=["serial", "fixed_chunk", "interference_aware"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a GPU) or cpu")
    ap.add_argument("--backend", default="torch", choices=SOLVER_BACKENDS,
                    help="the chunk prices' solver: torch on --device (default) or numpy")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.tiny:
        cfg = tiny_config(cfg)
    rng = np.random.default_rng(args.seed)
    prompts = []
    for _ in range(args.requests):
        plen = int(rng.integers(8, args.max_len - args.max_new - 1))
        prompts.append(rng.integers(1, cfg.vocab_size, size=plen).tolist())
    with solver_backend(args.backend, device=args.device):
        eng, metrics, dt = serve(
            cfg, EngineConfig(max_slots=args.slots, max_len=args.max_len,
                              mode=args.mode, seed=args.seed),
            prompts, args.max_new, device=args.device)
    toks = sum(m["new_tokens"] for m in metrics.values())
    print(f"mode={args.mode} device={eng.device}: {len(metrics)} requests, "
          f"{toks} tokens in {dt:.2f}s")
    chunks = [e.detail["chunk"] for e in eng.events
              if e.kind == "prefill_chunk"]
    print(f"prefill chunks: n={len(chunks)} sizes={chunks}")
    return metrics


if __name__ == "__main__":
    main()
