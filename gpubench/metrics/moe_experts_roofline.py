"""Kernels layer, a moe backlog cell: the expert kernels' share of their
roofline in the traced decode replays. Time: the device events whose name
holds ``moe_experts``. Bound, a replay: the layers times the larger of the
bytes over 3.35 TB/s and the operations over 989 TFLOP/s, where a layer's
active slots route ``active * k`` rows, reading the three matrices of
min(E, active * k) experts once and each routed row's input, intermediate
and output once, and computing 6 * d * f operations a routed row. A
program without the kernel, or a dense model, has nothing to read."""
from typing import Dict

from gpubench import counts, reduce

KERNELS = ("moe_experts",)


def layer_work(s: Dict, active: int) -> Dict[str, float]:
    """The bytes and operations of one moe layer's expert products for
    ``active`` decode rows."""
    m = s["moe"]
    d, f, E, k = s["d_model"], m["d_ff_expert"], m["n_experts"], m["top_k"]
    rows = active * k
    experts = min(E, rows)
    return {"bytes": counts.BF16_BYTES * (experts * 3 * d * f + rows * (d + f + d)),
            "flops": 6.0 * rows * d * f}


def read(rec):
    s = rec["shape"]
    if s.get("family") != "moe":
        return None
    bound, spent = 0.0, 0.0
    for r in reduce.replays(rec, "decode"):
        w = layer_work(s, len(reduce.active_positions(rec, r)))
        bound += s["n_layers"] * counts.bound_s(w["bytes"], w["flops"])
        spent += reduce.kernel_us(r["events"], KERNELS) / 1e6
    return 100.0 * bound / spent if spent > 0 else None
