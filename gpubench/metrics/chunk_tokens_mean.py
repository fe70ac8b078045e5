"""Scheduler layer: the mean size of the prefill chunks that the engine's
``prefill_chunk`` events record in the window (in a traced run, before the
traced slice)."""
from gpubench import reduce


def read(rec):
    sizes = [c for t, c in rec["chunks"] if 0.0 <= t < reduce.untraced_s(rec)]
    return sum(sizes) / len(sizes) if sizes else None
