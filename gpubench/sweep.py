"""The knee of an open-loop cell: the highest offered rate at which the
engine's admission queue does not grow over a window.

    python3 gpubench/sweep.py --workload qwen3-1.7b.chat --rates 4,6,8,10,12 --seconds 20

One set-up (weights from ``--seed``), then one window a rate on the same
engine, drained between rates. For each rate it prints a JSON line: the
rate offered, the end-to-end metrics, and the admission queue (requests
due and not yet admitted) at each tenth of the window with its slope in
requests/s over the window's second half. The queue grows where at some
tenth of the window it holds more than a second of arrivals (the engine
has fallen a second behind), or where it ends above a quarter of the
requests due in a tenth of the window and rises over the second half at
more than a twentieth of the rate. The knee is the last rate before the
first that grows.
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


def queue(rec, t: float) -> int:
    return sum(1 for r in rec["requests"]
               if r["due"] <= t and not (r["admit"] <= t))


def growth(rec, rate: float) -> dict:
    import numpy as np
    T = rec["seconds"]
    ts = [T * i / 10 for i in range(1, 11)]
    q = [queue(rec, t) for t in ts]
    half = [(t, n) for t, n in zip(ts, q) if t >= T / 2]
    slope = float(np.polyfit([t for t, _ in half], [n for _, n in half], 1)[0])
    grows = max(q) > rate or (q[-1] > max(2.0, rate * T / 40) and slope > rate / 20)
    return {"queue_by_tenth": q, "slope_per_s": slope, "grows": bool(grows)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True, help="comma-separated requests/s")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    harness.prepare()
    import torch
    from gpubench import reduce, spec
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    su = harness.Setup(cell, args.seed, "cuda")
    knee = None
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        w, drive = harness.make_window(cell, su, args.seed + i, args.seconds, rate=rate)
        drive()
        rec = w.record()
        w.close()
        su.eng.run_until_done(max_steps=10 ** 6)
        su.eng.events.clear()
        g = growth(rec, rate)
        line = {"rate_per_s": w.gen.rate, **reduce.end_to_end(rec), **g,
                "queue_wait_p95_ms": spec.load_reader("queue_wait_p95_ms")(rec),
                "unserved": harness.unserved(rec)}
        print(json.dumps(line), flush=True)
        if g["grows"]:
            break
        knee = w.gen.rate
    print(json.dumps({"workload": args.workload, "knee_per_s": knee,
                      "card": harness.card_info()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
