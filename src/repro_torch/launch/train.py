"""End-to-end training driver, the twin of ``src/repro/launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --steps 4 --batch 8 --seq 4096 --microbatches 4     # on the GPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --steps 20 --batch 4 --seq 32 --tiny --device cpu   # small, on the CPU

It keeps the reference's flags and runs the same Trainer on one device:
the card unless ``--device cpu`` is given (without a card it raises; it
never carries on on the CPU by itself). The reference also sets
``attn_impl="flashref"``; the port has no attention switch (its model runs
on the kernels on the card), so that override is not made.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.configs.registry import get_config, tiny_config
from repro_torch.data import DataConfig, Prefetcher, SyntheticLM
from repro_torch.models import build_model
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import leaves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--tiny", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a GPU) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.tiny:
        cfg = tiny_config(cfg)
    over = {}
    if args.d_model:
        over["d_model"] = args.d_model
    if args.n_layers:
        over["n_layers"] = args.n_layers
    cfg = cfg.with_overrides(**over)

    model = build_model(cfg, device=args.device)
    run = RunConfig(num_microbatches=args.microbatches,
                    optimizer=args.optimizer)
    tcfg = TrainerConfig(total_steps=args.steps, optimizer=args.optimizer,
                         lr=args.lr, checkpoint_dir=args.ckpt,
                         checkpoint_every=args.ckpt_every)
    trainer = Trainer(model, run, tcfg)

    data = Prefetcher(SyntheticLM(cfg, DataConfig(
        seq_len=args.seq, global_batch=args.batch,
        vocab_size=cfg.vocab_size, seed=args.seed)))
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    params, _, history = trainer.fit(data, gen)
    data.close()
    losses = [h[1] for h in history]
    print(f"\nfinal loss {losses[-1]:.4f} (start {losses[0]:.4f}); "
          f"params {sum(p.numel() for p in leaves(params)):,}")
    return losses


if __name__ == "__main__":
    main()
