"""From a window's record to numbers: the end-to-end metrics, and the
helpers that the per-layer readers (``gpubench/metrics/*.py``) share.

A record (``drive.Window.record``) holds times in seconds from the
window's start. Tails are over every sample (numpy's linear percentile);
rates over all the work and all the time of the window.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np

from gpubench import counts
from gpubench import trace as tr

DECODE_KERNELS = ("decode_partial_kernel", "decode_merge_kernel")
ATTENTION_KERNELS = ("flash_attention",)


def pct(values: Iterable[float], q: float) -> Optional[float]:
    v = np.asarray(list(values), dtype=np.float64)
    return float(np.percentile(v, q)) if v.size else None


def due_in_window(rec: Dict) -> List[Dict]:
    return [r for r in rec["requests"] if 0.0 <= r["due"] < rec["seconds"]]


def untraced_s(rec: Dict) -> float:
    """Where the host-side readers stop: the window's end, or in a traced
    run the traced slice's start (the profiler's start stalls the host)."""
    return rec["trace"]["slice"][0] if rec.get("trace") else rec["seconds"]


# ------------------------------------------------------------- end to end
def ttft_ms(rec: Dict) -> List[float]:
    """Due time to first token, of every request due in the window that has one."""
    return [(r["times"][0] - r["due"]) * 1e3 for r in due_in_window(rec) if r["times"]]


def tbt_ms(rec: Dict) -> List[float]:
    """Every gap between a request's consecutive tokens, of the tokens
    emitted in the window."""
    T = rec["seconds"]
    out = []
    for r in rec["requests"]:
        t = r["times"]
        out += [(b - a) * 1e3 for a, b in zip(t, t[1:]) if 0.0 <= b <= T]
    return out


def tokens_in_window(rec: Dict) -> int:
    T = rec["seconds"]
    return sum(1 for r in rec["requests"] for t in r["times"] if 0.0 <= t <= T)


def end_to_end(rec: Dict) -> Dict[str, Optional[float]]:
    return {"ttft_p95_ms": pct(ttft_ms(rec), 95),
            "tbt_p99_ms": pct(tbt_ms(rec), 99),
            "tokens_per_s": tokens_in_window(rec) / rec["seconds"]}


# ------------------------------------------------------------- the trace
def replays(rec: Dict, kind: str) -> List[Dict]:
    t = rec.get("trace")
    return [r for r in t["replays"] if r["kind"] == kind] if t else []


def kernel_us(events, names) -> float:
    return sum(e.dur_us for e in events if any(n in e.name for n in names))


def busy_us(replay: Dict) -> float:
    return tr.union_us(replay["events"])


def active_positions(rec: Dict, replay: Dict) -> np.ndarray:
    """The positions of the tokens a decode replay fed for its active
    slots (an idle slot is fed at the trash position ``max_len``)."""
    pos = replay["pos"]
    return pos[pos < rec["max_len"]]


def replay_flops(rec: Dict, replay: Dict) -> float:
    s = rec["shape"]
    if replay["kind"] == "decode":
        return sum(counts.token_flops(s, int(p), logits=True)
                   for p in active_positions(rec, replay))
    return counts.chunk_flops(s, replay["c"], replay["pos0"])


def waits_s(rec: Dict) -> float:
    """The harness's waits for the next arrival in the traced slice, when
    no request was in the engine."""
    t = rec["trace"]
    return sum(b - a for label, a, b in t["host"] if label.startswith("harness: waiting"))


def serving_s(rec: Dict) -> float:
    """The traced slice's length, the harness's waits left out."""
    a, b = rec["trace"]["slice"]
    return (b - a) - waits_s(rec)


def slice_busy_us(rec: Dict) -> float:
    return tr.union_us(rec["trace"]["events"])


def idle_share(rec: Dict) -> Optional[float]:
    if not rec.get("trace"):
        return None
    return 100.0 * (1.0 - slice_busy_us(rec) / 1e6 / serving_s(rec))


def decode_roofline(rec: Dict) -> Optional[float]:
    """flash_decode's bound over its device time in the traced decode
    replays. The bound counts the active slots' keys and values."""
    s, bound, spent = rec["shape"], 0.0, 0.0
    for r in replays(rec, "decode"):
        lens = active_positions(rec, r) + 1
        bound += counts.bound_s(counts.decode_attention_bytes(s, lens), 0.0)
        spent += kernel_us(r["events"], DECODE_KERNELS) / 1e6
    return 100.0 * bound / spent if spent > 0 else None


def attention_roofline(rec: Dict) -> Optional[float]:
    """flash_attention's bound over its device time in the traced extend
    replays: the larger of the chunk's causal operations over the bf16
    peak and its bytes over the memory's rate, summed over the chunks."""
    s, bound, spent = rec["shape"], 0.0, 0.0
    for r in replays(rec, "extend"):
        w = counts.chunk_attention(s, r["c"], r["pos0"])
        bound += counts.bound_s(w["bytes"], w["flops"])
        spent += kernel_us(r["events"], ATTENTION_KERNELS) / 1e6
    return 100.0 * bound / spent if spent > 0 else None


def replays_mfu(rec: Dict, kind: str) -> Optional[float]:
    """The model's operations of one kind of replay over the device time
    those replays took, as a share of the bf16 peak."""
    rs = replays(rec, kind)
    spent = sum(busy_us(r) for r in rs) / 1e6
    if spent <= 0:
        return None
    return 100.0 * sum(replay_flops(rec, r) for r in rs) / (spent * counts.PEAK_BF16_FLOPS)


def step_mfu(rec: Dict) -> Optional[float]:
    """Every traced replay's model operations over the traced slice's
    serving time (its waits for arrivals left out), as a share of the peak."""
    t = rec.get("trace")
    if not t or not t["replays"]:
        return None
    flops = sum(replay_flops(rec, r) for r in t["replays"])
    return 100.0 * flops / (serving_s(rec) * counts.PEAK_BF16_FLOPS)


def breakdown(rec: Dict, n: int = 10) -> Dict:
    """The device operations that took most of the slice, and its idle
    gaps summed by what the host was doing (the innermost host span around
    a gap's middle, on the host clock through the markers' offset)."""
    t = rec["trace"]
    by_name: Dict[str, float] = {}
    for e in t["events"]:
        by_name[e.name[:96]] = by_name.get(e.name[:96], 0.0) + e.dur_us / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    spans = sorted(t["host"], key=lambda h: h[2] - h[1])
    gaps: Dict[str, float] = {}
    for a, b in tr.gaps(t["events"]):
        mid = ((a + b) / 2 - t["offset_us"]) / 1e6
        label = next((h[0] for h in spans if h[1] <= mid <= h[2]),
                     "harness: python between steps")
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in idle]}
