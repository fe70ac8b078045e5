"""Scheduler layer: the mean host time of ``Engine._pick_chunk`` (the
chunk's price on the interference estimator) over its calls in the window
(in a traced run, before the traced slice)."""
from gpubench import reduce


def read(rec):
    ms = [m for t, m, _ in rec["picks"] if 0.0 <= t < reduce.untraced_s(rec)]
    return sum(ms) / len(ms) if ms else None
