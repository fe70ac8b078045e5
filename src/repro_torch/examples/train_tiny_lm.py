"""End-to-end training run: a ~100M-parameter qwen3-family LM trained
for a few hundred steps on the synthetic pipeline, with checkpointing,
auto-resume and straggler monitoring — the full production loop at a
small scale; the twin of ``examples/train_tiny_lm.py``.

On the card ``rmsnorm`` and ``flash_attention`` run on their kernels, the
backward being the plain versions' VJP (``kernels/_grad.py``). The
reference also sets ``attn_impl="flashref"``; this package has no
attention switch, so that override is not made. The checkpoints go to
``--ckpt`` (``results/tiny_lm_torch`` by default), from which a second run
resumes. ``--device-model`` and ``--backend`` are taken as by every twin;
training prices nothing.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_tiny_lm [--steps 300] [--device cpu]
"""
import torch

from repro_torch.configs.base import RunConfig
from repro_torch.configs.registry import get_config
from repro_torch.data import DataConfig, Prefetcher, SyntheticLM
from repro_torch.examples import arguments, pricing
from repro_torch.models import build_model
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    """Returns the (step, loss, seconds) history of the run."""
    ap = arguments(__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default="results/tiny_lm_torch")
    args = ap.parse_args(argv)

    # ~100M params: a scaled-down qwen3 (same family: qk-norm, GQA)
    cfg = get_config("qwen3-1.7b").with_overrides(
        n_layers=6, d_model=512, d_ff=1536, vocab_size=8192,
        attn=get_config("qwen3-1.7b").attn.__class__(
            n_heads=8, n_kv_heads=4, head_dim=64, qk_norm=True))
    with pricing(args):
        model = build_model(cfg, device=args.device)
        print(f"params: {cfg.n_params() / 1e6:.1f}M")

        tcfg = TrainerConfig(total_steps=args.steps, log_every=20,
                             checkpoint_dir=args.ckpt, checkpoint_every=100,
                             optimizer="adamw", lr=3e-4)
        trainer = Trainer(model, RunConfig(num_microbatches=2), tcfg)
        data = Prefetcher(SyntheticLM(cfg, DataConfig(
            seq_len=256, global_batch=8, vocab_size=cfg.vocab_size)))
        try:
            _, _, history = trainer.fit(
                data, torch.Generator(device=model.device).manual_seed(0))
        finally:
            data.close()
    first, last = history[0][1], history[-1][1]
    print(f"\nloss {first:.3f} -> {last:.3f} "
          f"({'OK: learning' if last < first - 0.3 else 'check convergence'})")
    if trainer.straggler.events:
        print(f"straggler events: {trainer.straggler.events}")
    return history


if __name__ == "__main__":
    main()
