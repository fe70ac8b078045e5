"""One run of one cell of the benchmark of ``repro_torch``'s serving engine.

    python3 gpubench/run.py --workload qwen3-1.7b.chat --seed 7 --seconds 30 --trace 0

Builds the cell named in ``BENCHMARK.json`` from its files (configuration,
traffic mix, cell), draws weights and traffic from ``--seed``, warms the
engine up, drives it for ``--seconds``, checks the served tokens against
the plain reference, and prints one JSON object as the last line of
standard output: the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics (from a device trace of a slice of the window) with
``--trace 1``. Set-up, the generator's lateness, the chunk sizes, peak
memory and the card go to standard error, and the numbers compared with
their limits are its last lines. Without enough CUDA cards it exits 2 and
prints no result; it never falls back to the CPU.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path.pop(0)          # the folder's modules live under the name gpubench
sys.path.insert(0, str(HERE.parent))

from gpubench import harness  # noqa: E402

TRACE_S = 3.0                # the traced slice, in the window's middle


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def run(workload: str, seed: int, seconds: float, traced: bool, device: str = "cuda",
        root: Path = harness.ROOT, t_start: float = T_START) -> dict:
    """The result object of one run (``correct`` decided, metrics read)."""
    import torch
    from gpubench import check, reduce, spec
    base = root / "gpubench"
    cell = spec.load_cell(workload, root, base)
    su = harness.Setup(cell, seed, device, traced)
    w, drive = harness.make_window(cell, su, seed, seconds, TRACE_S if traced else 0.0)
    drive()
    rec = w.record()
    rec["shape"] = su.shape
    rec["trace"] = w.trace_record() if traced else None
    setup_s = w.t0 - t_start
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    log(f"setup_s {setup_s} parts {json.dumps(su.parts)}")
    log(f"captures_s {json.dumps(su.captures)}")
    if cell.traffic["loop"] == "open":
        log(f"generator_late_ms {json.dumps(harness.lateness_ms(rec))}")
    sizes = [c for _, c in rec["chunks"]]
    log(f"chunks n {len(sizes)} mean {sum(sizes) / max(len(sizes), 1)} "
        f"max {max(sizes, default=0)}")
    log(f"requests submitted {len(rec['requests'])} steps {len(rec['steps'])} "
        f"memory_peak_bytes {peak} weight_bytes {su.weight_bytes}")
    if device == "cuda":
        log(f"card {harness.card_info()}")

    metrics = {}
    if traced:
        for m in cell.per_layer:
            v = spec.load_reader(m.name, base)(rec)
            if v is not None:
                metrics[m.name] = {"value": v, "unit": m.unit}
    else:
        values = dict(reduce.end_to_end(rec), setup_s=setup_s)
        for m in cell.end_to_end:
            if values.get(m.name) is not None:
                metrics[m.name] = {"value": values[m.name], "unit": m.unit}

    picked = check.sample(harness.finished(w), seed, **cell.traffic["check"])
    missing = harness.unserved(rec) if cell.traffic["loop"] == "open" else 0
    attempted = (len(reduce.due_in_window(rec)) if cell.traffic["loop"] == "open"
                 else sum(1 for r in rec["requests"]
                          if any(0.0 <= t <= seconds for t in r["times"])))
    w = None
    su.free_engine()
    reading = check.readings(su.weights, su.shape, picked)
    limit = cell.cell["logit_gap_limit"]
    checks = {"logit_gap": {"value": reading["program"], "limit": limit},
              "unserved": {"value": missing, "limit": 0},
              "compared_tokens": {"value": reading["tokens"], "limit": 1}}
    correct = (reading["program"] <= limit and missing == 0 and reading["tokens"] >= 1)
    out = {"correct": correct, "attempted": attempted, "failed": missing,
           "metrics": metrics,
           "device": {"platform": "gpu" if device == "cuda" else device,
                      "kind": torch.cuda.get_device_name() if device == "cuda" else device,
                      "count": 1, "memory_peak_bytes": peak}}
    if rec["trace"]:
        busy = reduce.slice_busy_us(rec) / 1e6
        a, b = rec["trace"]["slice"]
        out["device"].update(busy_s=busy, window_s=b - a)
        out["breakdown"] = reduce.breakdown(rec)
        log(f"trace prefix_kept {rec['trace']['prefix_kept']} of 8192, "
            f"replays {len(rec['trace']['replays'])}, lost {rec['trace']['lost_replays']}, "
            f"median delay {rec['trace']['median_delay_us']} us, "
            f"start_s {rec['trace']['start_s']}")
    for k, v in checks.items():
        log(f"check {k} {v['value']} limit {v['limit']}")
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.prepare()
    import torch
    from gpubench import spec
    chips = spec.load_cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    out = run(args.workload, args.seed, args.seconds, bool(args.trace))
    found = harness.forbidden_modules()
    if found:
        log(f"modules of JAX or of the JAX package were loaded: {found}")
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
