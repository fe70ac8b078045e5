"""Readings of the engine's own spans (``Engine.trace``), written against
the record a reader receives: ``rec["spans"]`` holds ``Engine.spans()``
with every time in seconds from the window's start (``shifted``), and each
reading covers the steps that start before a traced run's profiler slice
(``reduce.untraced_s``). No cell records spans yet: the window has to
switch the engine's tracing on first (PERF.md §7), and each reading below
then becomes a reader under ``gpubench/metrics/``. A reading is None where
there is nothing to read: no spans, or, off the card, no device intervals.

A span's device interval opens when its first replay is enqueued, so on an
idle card it holds the graph's launch, and closes when its last work ends;
the union of the intervals counts the gaps between kernels inside a replay
as busy (a profiler's union of kernels does not).
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional

from gpubench import reduce

BETWEEN = "harness: between steps"
WAITING = "harness: waiting for an arrival"


def shifted(spans: List[Dict], t0: float) -> List[Dict]:
    """The spans with their times in seconds from ``t0``."""
    out = []
    for s in spans:
        d = s["device"]
        out.append(dict(s, start=s["start"] - t0, end=s["end"] - t0,
                        device=None if d is None else (d[0] - t0, d[1] - t0)))
    return out


def _roots(spans: List[Dict]) -> Dict[int, int]:
    """Each span's step root, by index."""
    by = {s["index"]: s for s in spans}
    out = {}
    for s in spans:
        r = s
        while r["parent"] is not None and r["parent"] in by:
            r = by[r["parent"]]
        out[s["index"]] = r["index"]
    return out


def window(rec: Dict) -> List[Dict]:
    """The spans of the steps that start in [0, ``untraced_s``), children
    with their root."""
    spans = rec.get("spans") or []
    end = reduce.untraced_s(rec)
    keep = {s["index"] for s in spans if s["parent"] is None and 0.0 <= s["start"] < end}
    root = _roots(spans)
    return [s for s in spans if root[s["index"]] in keep]


def _steps(spans: List[Dict]) -> List[Dict]:
    return sorted((s for s in spans if s["parent"] is None), key=lambda s: s["start"])


def merged(spans: List[Dict]) -> List[tuple]:
    """The union of the spans' device intervals, as sorted disjoint intervals."""
    out: List[list] = []
    for a, b in sorted(s["device"] for s in spans if s["device"] is not None):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def waits(spans: List[Dict]) -> List[tuple]:
    """The gaps after a step that left the engine empty (``left`` 0) and
    before the next one: the harness waiting for an arrival."""
    steps = _steps(spans)
    return [(r["end"], n["start"]) for r, n in zip(steps, steps[1:]) if r.get("left") == 0]


def _overlap(intervals: List[tuple], a: float, b: float) -> float:
    return sum(max(0.0, min(y, b) - max(x, a)) for x, y in intervals)


def device_idle_share(rec: Dict) -> Optional[float]:
    """1 - the union of the device intervals / the untraced part's seconds,
    the harness's waits for an arrival left out, in %."""
    spans = window(rec)
    iv = merged(spans)
    if not iv:
        return None
    end = reduce.untraced_s(rec)
    serving = end - _overlap(waits(spans), 0.0, end)
    return 100.0 * (1.0 - _overlap(iv, 0.0, end) / serving)


def idle_by_phase(rec: Dict) -> Dict[str, float]:
    """The idle seconds between the device intervals of the untraced part,
    each gap summed under the innermost span around its middle (the
    shortest one holding it), or the harness's between steps or waiting
    for an arrival; largest first."""
    spans = window(rec)
    iv = merged(spans)
    end = reduce.untraced_s(rec)
    steps = _steps(spans)
    starts = [r["start"] for r in steps]
    root = _roots(spans)
    kids: Dict[int, List[Dict]] = {}
    for s in spans:
        kids.setdefault(root[s["index"]], []).append(s)
    out: Dict[str, float] = {}
    for (_, x), (y, _) in zip(iv, iv[1:]):
        x, y = max(x, 0.0), min(y, end)
        if y <= x:
            continue
        mid = (x + y) / 2
        k = bisect.bisect_right(starts, mid) - 1
        label = BETWEEN
        if k >= 0:
            r = steps[k]
            inside = [s for s in kids[r["index"]] if s["start"] <= mid <= s["end"]]
            if inside:
                label = min(inside, key=lambda s: s["end"] - s["start"])["name"]
            elif r.get("left") == 0:
                label = WAITING
        out[label] = out.get(label, 0.0) + (y - x)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def step_turnaround_ms(rec: Dict) -> Optional[float]:
    """The mean device idle between one step's last device interval and
    the next step's first, over consecutive steps that both ran device
    work with no wait for an arrival between them: the host's turn."""
    spans = window(rec)
    root = _roots(spans)
    first: Dict[int, float] = {}
    last: Dict[int, float] = {}
    for s in spans:
        if s["device"] is not None:
            r = root[s["index"]]
            first[r] = min(first.get(r, s["device"][0]), s["device"][0])
            last[r] = max(last.get(r, s["device"][1]), s["device"][1])
    steps = _steps(spans)
    idle = [max(0.0, first[n["index"]] - last[r["index"]]) for r, n in zip(steps, steps[1:])
            if r["index"] in last and n["index"] in first and r.get("left") != 0]
    return _mean_ms(idle)


def _mean_ms(values: List[float]) -> Optional[float]:
    return 1e3 * sum(values) / len(values) if values else None


def solve_ms(rec: Dict) -> Optional[float]:
    """The mean host duration of the ``solve`` spans (the captured solve's
    write, replay and readback); ``pick_chunk_ms`` less this is the
    Python pricing."""
    return _mean_ms([s["end"] - s["start"] for s in window(rec) if s["name"] == "solve"])


def replay_launch_ms(rec: Dict) -> Optional[float]:
    """The mean host time of the ``decode`` and ``extend`` spans before
    their device intervals open: the static input write and the graph
    launch (the whole span where the card was still busy with earlier
    work when it closed)."""
    return _mean_ms([min(max(s["device"][0], s["start"]), s["end"]) - s["start"]
                     for s in window(rec) if s["name"] in ("decode", "extend")
                     and s["device"] is not None])


def extend_pad_share(rec: Dict) -> Optional[float]:
    """Padding rows over bucket rows of the ``extend`` spans (counters ``c``
    of ``rows``), in %."""
    ext = [s for s in window(rec) if s["name"] == "extend"]
    rows = sum(s["rows"] for s in ext)
    return 100.0 * sum(s["rows"] - s["c"] for s in ext) / rows if rows else None


def decode_idle_rows_share(rec: Dict) -> Optional[float]:
    """The rows a decode step computes for no request: 1 - active rows /
    the step's slots (counters ``rows`` of ``slots``) over the ``decode``
    spans, in %."""
    dec = [s for s in window(rec) if s["name"] == "decode"]
    slots = sum(s["slots"] for s in dec)
    return 100.0 * (1.0 - sum(s["rows"] for s in dec) / slots) if slots else None


def admit_us_per_request(rec: Dict) -> Optional[float]:
    """The host time of the ``admit`` spans over the requests they admitted
    (counter ``n``), in µs: admission's cost a request, the steps that
    admitted none included."""
    adm = [s for s in window(rec) if s["name"] == "admit"]
    n = sum(s["n"] for s in adm)
    return 1e6 * sum(s["end"] - s["start"] for s in adm) / n if n else None
