"""The device trace of a slice of the window, read from the profiler's raw
results (the method of ``chip_smoke.py``'s ``profile_step``, copied).

A trace drops its first device events, so it opens with ``PREFIX``
launches of ``torch.cuda._sleep(0)`` for it to drop in place of the
steps' kernels, and one launch of the program's empty kernel
(``rt_empty``) as a fence; it fails if it lost every launch before the
fence. Every replay of a captured step in the slice then lies between a
begin marker (``rt_empty``) and an end marker (``torch.cuda._sleep(0)``),
so that the device events of each replay are known. A trace can also
drop a marker later on: a replay whose begin or end marker is missing
is left out, and the others keep their places. The trace stays in memory.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

PREFIX = 8192
MARKER = "empty_kernel"
SPIN = "spin_kernel"
LAUNCH_US = 100.0           # a marker launched onto an idle card runs within this


class DeviceEvent(NamedTuple):
    name: str
    start_us: float          # the device's clock
    dur_us: float


def begin() -> None:
    """One launch of the empty kernel: the marker before a traced replay."""
    from repro_torch.kernels import _build
    _build.check_launch(_build.load().rt_empty(_build.stream_ptr()), "rt_empty")


def end() -> None:
    """The marker after a traced replay."""
    torch.cuda._sleep(0)


def start():
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    for _ in range(PREFIX):
        torch.cuda._sleep(0)
    begin()                     # the fence
    return prof


def warm() -> float:
    """One short trace, read and dropped, so that the profiler's first start
    (seconds of set-up on the card) falls outside the window. Returns the
    seconds it took."""
    import time
    t = time.perf_counter()
    prof = start()
    torch.cuda.synchronize()
    prof.stop()
    device_events(prof)
    return time.perf_counter() - t


def device_events(prof) -> List[DeviceEvent]:
    """The device events of a stopped trace, in order of their start."""
    raw = [(e.name(), e.start_ns() / 1e3, e.duration_ns() / 1e3)
           for e in prof.profiler.kineto_results.events() if e.device_type().name == "CUDA"]
    return sorted((DeviceEvent(*r) for r in raw), key=lambda ev: ev.start_us)


def split(events: List[DeviceEvent]):
    """(the complete replays, as (begin marker's device start, its events),
    in order; the markers left without a partner, whose replays are lost;
    the prefix launches kept before the fence)."""
    fences = [i for i, ev in enumerate(events) if MARKER in ev.name]
    if not fences:
        raise RuntimeError("the trace holds no marker")
    fence = fences[0]
    kept = sum(SPIN in ev.name for ev in events[:fence])
    if not kept:
        raise RuntimeError(f"the trace lost every one of its {PREFIX} opening launches")
    complete, broken, open_at = [], 0, None
    for i in range(fence + 1, len(events)):
        name = events[i].name
        if MARKER in name:
            broken += open_at is not None            # the previous replay lost its end
            open_at = i
        elif SPIN in name:
            if open_at is None:                      # this replay lost its begin
                broken += 1
            else:
                complete.append((events[open_at].start_us, events[open_at + 1:i]))
                open_at = None
    return complete, broken + (open_at is not None), kept


def clock_shift(starts_us, host_us, span_us: float = 20e3, step_us: float = 10.0) -> float:
    """The shift from the profiler's clock to the host's at which most begin
    markers ran within ``LAUNCH_US`` of the latest launch before them: at
    the start of a step the card is idle and runs a marker as it comes.
    Both clocks count from the epoch, the profiler's to a few ms."""
    d = np.asarray(starts_us, dtype=np.float64)
    h = np.asarray(host_us, dtype=np.float64)
    best, best_score = 0.0, None
    for c in np.arange(-span_us, span_us + step_us, step_us):
        x = d - c
        k = np.searchsorted(h, x, side="right") - 1
        r = (x - h[np.maximum(k, 0)])[k >= 0]
        near = r[r <= LAUNCH_US]
        score = (near.size, -float(near.sum()))        # most markers, then the nearest
        if best_score is None or score > best_score:
            best, best_score = float(c), score
    return best


def assign(complete, broken: int, host_us: List[float], kinds: List[str]):
    """Which traced replay each complete one is: (the events of each host
    replay, None where lost; the device's delay after each begin marker's
    launch, of those found). Where no marker was lost, the k-th marker pair
    is the k-th replay. Otherwise each pair is the latest replay of its kind
    launched before its begin marker ran, the profiler's clock brought to
    the host's by ``clock_shift``."""
    n = len(host_us)
    out = [None] * n
    if len(complete) == n and broken == 0:
        for i, (d, ev) in enumerate(complete):
            out[i] = ev
        return out, [d - h for (d, _), h in zip(complete, host_us)]
    shift = clock_shift([d for d, _ in complete], host_us)
    delays, i = [], 0
    for d, ev in complete:
        d -= shift
        kind = "decode" if any("decode_partial_kernel" in e.name for e in ev) else "extend"
        while i + 1 < n and host_us[i + 1] <= d:
            i += 1
        j = i
        while j >= 0 and (out[j] is not None or kinds[j] != kind):
            j -= 1
        if j >= 0 and host_us[j] <= d:
            out[j] = ev
            delays.append(d - host_us[j] + shift)
    if not delays:
        raise RuntimeError(f"{n} replays traced, {len(complete)} whole in the trace, and "
                           "the host's clock places none of them")
    return out, delays


def union_us(events: List[DeviceEvent]) -> float:
    """The time in which at least one of ``events`` ran."""
    total, end = 0.0, float("-inf")
    for ev in sorted(events, key=lambda e: e.start_us):
        a, b = ev.start_us, ev.start_us + ev.dur_us
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def gaps(events: List[DeviceEvent]):
    """The idle intervals (start, end) between the union of ``events``."""
    out, end = [], None
    for ev in sorted(events, key=lambda e: e.start_us):
        if end is not None and ev.start_us > end:
            out.append((end, ev.start_us))
        end = max(end if end is not None else ev.start_us, ev.start_us + ev.dur_us)
    return out
