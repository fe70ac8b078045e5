"""Steps layer: the device time of a decode replay (the union of its
kernels' intervals between its two markers), the mean over the traced slice."""
from gpubench import reduce


def read(rec):
    rs = reduce.replays(rec, "decode")
    return sum(reduce.busy_us(r) for r in rs) / len(rs) / 1e3 if rs else None
