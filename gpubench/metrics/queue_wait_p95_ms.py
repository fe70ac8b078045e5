"""Engine layer: the 95th percentile over the requests due in the window of
the time from a request's due time to the engine's ``admit`` event (in a
traced run, of the requests due before the traced slice)."""
import math

from gpubench import reduce


def read(rec):
    end = reduce.untraced_s(rec)
    waits = [(r["admit"] - r["due"]) * 1e3 for r in reduce.due_in_window(rec)
             if r["due"] < end and not math.isnan(r["admit"])]
    return reduce.pct(waits, 95)
