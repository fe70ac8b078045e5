"""The readings that a cell's correctness limit is set from.

    python3 gpubench/calibrate.py --workload qwen3-1.7b.chat --seeds 1,2,3 --seconds 10

For each seed: the cell's set-up, a window at the cell's own load, and the
sample that ``run.py`` compares. It prints one JSON line a seed: the widest
gap of the program's served tokens under the f32 reference (the lower
reading), and that of the tokens the float8 control puts first at the
same positions (the upper reading), with the tokens and requests compared.
"""
import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path.pop(0)
sys.path.insert(0, str(HERE.parent))

from gpubench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    harness.prepare()
    import torch
    from gpubench import spec
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.readings(cell, seed, args.seconds, bool(args.control))
        print(json.dumps({"workload": args.workload, "seed": seed, **r}), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"card": harness.card_info()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
