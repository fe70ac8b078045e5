"""Per-(arch, shape) RunConfig overrides produced by the §Perf hillclimb.

Provenance for each entry is the iteration log in EXPERIMENTS.md §Perf
(hypothesis -> change -> before -> after -> confirmed/refuted).
"""
from repro_torch.configs.base import RunConfig

PERF_OVERRIDES: dict = {
    # A-series: falcon-mamba train — after the sequential-scan rewrite the
    # activation floor allows mb=8, which fits HBM (13GB/chip)
    ("falcon-mamba-7b", "train_4k"): RunConfig(
        num_microbatches=8, optimizer="adamw"),
    # B-series: llama3-405b train — mb=8 minimizes the per-microbatch
    # weight-gather + grad-reduce volume (coll 90s -> 68s); mb=16 is the
    # HBM-conservative setting (66GB vs 117GB CPU-inflated temp).
    ("llama3-405b", "train_4k"): RunConfig(
        num_microbatches=16, optimizer="adafactor"),
    ("zamba2-1.2b", "train_4k"): RunConfig(num_microbatches=8),
}
